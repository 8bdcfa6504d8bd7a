"""The port's BatchNorm, convolution and pooling against the JAX package's.

Same numpy inputs (seeded) through `mxnet_tpu.ops.nn` and
`mxnet_tpu_torch.ops.nn` on the CPU; the reference's B1 kernel runs as
Pallas in interpret mode with explicit tiles (no autotune cache is
read), the port's through its plain version (a CPU tensor).

Tolerances:
- B1 sums, f32: both sides sum M products in f32 in different orders;
  the error of either is at most about depth * 2^-24 * sum|term|, so the
  two are held within 2^-24 * 2 * M * sum|term| per channel (the loose
  worst case; a missing or doubled row would exceed it by orders of
  magnitude at these sizes).
- BN forward/backward in f32: the same formulas, the sums in other
  orders: out, dx at atol = rtol = 1e-5 (values of order 1-3);
  dgamma, dbeta at 1e-4 x their magnitude plus rtol 1e-5.
- BN in bf16: both compute in f32 and round once to bf16 at the same
  points, except where XLA keeps f32 between elementwise ops that torch
  rounds (the running statistics' ``old * m + new * (1 - m)`` in bf16):
  one bf16 ulp, rtol 2^-7 (2^-6 for values that passed two roundings),
  plus atol 1e-2 where a sum of order 1-10 rounds to bf16.
- convolution and pooling in f32: products in true f32, other
  summation orders: atol = rtol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import nn as ref_nn
from mxnet_tpu_torch import autograd, npx
from mxnet_tpu_torch.ops import nn as port_nn
from mxnet_tpu_torch.ops.aux_scope import aux_update_scope

torch.set_num_threads(1)

EPS32 = 2.0 ** -24


# ---------------------------------------------------------------------------
# B1: the joint reduction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,c", [(64, 3), (203, 3), (1000, 128), (517, 40)])
def test_bn_bwd_reduce_plain_matches_pallas(m, c):
    rng = onp.random.default_rng(m * 7 + c)
    dy = rng.standard_normal((m, c)).astype(onp.float32)
    xh = rng.standard_normal((m, c)).astype(onp.float32)
    tm = 8 if m % 8 == 0 else m
    s_r, ss_r = ref_nn.bn_bwd_reduce_pallas(jnp.asarray(dy), jnp.asarray(xh),
                                            tm=tm, tn=c, interpret=True)
    # the port's (N0, C, N1) view of the same channel-minor data
    s_p, ss_p = port_nn.bn_bwd_reduce(torch.from_numpy(dy.T.copy())[None],
                                      torch.from_numpy(xh.T.copy())[None])
    assert s_p.dtype == torch.float32 and s_p.shape == (c,)
    tol_s = 2 * m * EPS32 * onp.abs(dy).sum(0)
    tol_ss = 2 * m * EPS32 * onp.abs(dy * xh).sum(0)
    assert (onp.abs(s_p.numpy() - onp.asarray(s_r)) <= tol_s).all()
    assert (onp.abs(ss_p.numpy() - onp.asarray(ss_r)) <= tol_ss).all()


def test_bn_bwd_reduce_views_and_checks():
    """An NCHW tensor viewed as (N, C, H*W) sums what the reference's
    channel-minor (N*H*W, C) view sums; bad inputs raise."""
    rng = onp.random.default_rng(5)
    dy = rng.standard_normal((3, 5, 4, 7)).astype(onp.float32)
    xh = rng.standard_normal((3, 5, 4, 7)).astype(onp.float32)
    s, ss = port_nn.bn_bwd_reduce(torch.from_numpy(dy).view(3, 5, 28),
                                  torch.from_numpy(xh).view(3, 5, 28))
    onp.testing.assert_allclose(s.numpy(), dy.sum((0, 2, 3)), rtol=1e-5,
                                atol=1e-5)
    onp.testing.assert_allclose(ss.numpy(), (dy * xh).sum((0, 2, 3)),
                                rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="N0, C, N1"):
        port_nn.bn_bwd_reduce(torch.zeros(3, 4), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        port_nn.bn_bwd_reduce(torch.zeros(1, 2, 3, device="meta"),
                              torch.zeros(1, 2, 3, device="meta"))


def test_bn_bwd_reduce_plan_covers_every_element():
    for n0, c, n1 in [(128, 64, 12544), (128, 2048, 49), (2, 3, 5),
                      (1, 1, 1), (128, 256, 784)]:
        splits, chunk = port_nn.bn_bwd_reduce_plan(n0, c, n1)
        m = n0 * n1
        assert splits >= 1 and (splits - 1) * chunk < m <= splits * chunk


def _rows_visits(n0, c, n1, plan):
    """How many times B1's channel-minor kernel (`bn_reduce_rows_partial`
    in `csrc/bn_bwd_reduce.cu`, its loops spelled in numpy) reads each
    element of the (N0, C * N1) view under ``plan``."""
    vec, tw, splits, chunk = plan
    w = c * n1
    ncol, rp = tw * vec, 256 // tw
    tiles = -(-w // ncol)
    count = onp.zeros((n0, w), onp.int64)
    for s in range(splits):
        r0, r1 = s * chunk, min(s * chunk + chunk, n0)
        for tile in range(tiles):
            for t in range(256):
                tx, ty = t % tw, t // tw
                col = tile * ncol + tx * vec
                if col < w:
                    count[r0 + ty:r1:rp, col:col + vec] += 1
    return count


@pytest.mark.parametrize("n0,c,n1,aligned", [
    (1605632, 64, 1, True),     # ResNet-50's NHWC stem BatchNorm
    (6272, 2048, 1, True),      # its last stage
    (2331, 3, 1, True),         # C off every tile, odd M
    (5, 130, 1, True),          # W % 4 != 0: scalar loads, 3 column tiles
    (37, 1, 1, True),           # one channel
    (9, 6, 3, True),            # N1 = 3, W = 18 (no float4)
    (11, 64, 2, False),         # a misaligned pointer: no float4
    (3, 1000, 1, True),         # M below the 4 rows a pass, 4 column tiles
    (300, 64, 1, True),         # 16 column threads, 16 rows a pass
    (700, 256, 1, True),        # 6 row ranges of 117
])
def test_bn_bwd_reduce_rows_plan_reads_every_element_once(n0, c, n1,
                                                          aligned):
    vec, tw, splits, chunk = plan = port_nn.bn_bwd_reduce_rows_plan(
        n0, c, n1, aligned)
    w = c * n1
    assert vec == (4 if aligned and w % 4 == 0 else 1)
    assert tw & (tw - 1) == 0 and 1 <= tw <= 64
    assert tw == 64 or tw * vec >= w
    assert splits >= 1 and (splits - 1) * chunk < n0 <= splits * chunk
    if n0 * w <= 200_000:
        assert (_rows_visits(n0, c, n1, plan) == 1).all()



# ---------------------------------------------------------------------------
# BatchNorm train forward and backward
# ---------------------------------------------------------------------------
def _bn_inputs(shape, axis, seed):
    rng = onp.random.default_rng(seed)
    c = shape[axis]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(onp.float32)
    gamma = (1 + 0.2 * rng.standard_normal(c)).astype(onp.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(onp.float32)
    mm = (0.1 * rng.standard_normal(c)).astype(onp.float32)
    mv = (1 + 0.1 * rng.random(c)).astype(onp.float32)
    dy = rng.standard_normal(shape).astype(onp.float32)
    return x, gamma, beta, mm, mv, dy


def _ref_bn(x, gamma, beta, mm, mv, dy, axis, jdt):
    args = [jnp.asarray(a).astype(jdt) for a in (x, gamma, beta)]
    stats = [jnp.asarray(a).astype(jdt) for a in (mm, mv)]

    def f(xx, g, b):
        return ref_nn.batch_norm_train(xx, g, b, 0.9, 1e-5, axis, *stats)

    (out, nm, nv), vjp = jax.vjp(f, *args)
    dx, dg, db = vjp((jnp.asarray(dy).astype(jdt), jnp.zeros_like(nm),
                      jnp.zeros_like(nv)))
    return [onp.asarray(jnp.asarray(a, jnp.float32))
            for a in (out, nm, nv, dx, dg, db)]


def _port_bn(x, gamma, beta, mm, mv, dy, axis, tdt):
    xt, gt, bt = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, gamma, beta))
    mmt, mvt = (torch.from_numpy(a).to(tdt) for a in (mm, mv))
    out, nm, nv = port_nn.batch_norm_train(xt, gt, bt, 0.9, 1e-5, axis, mmt,
                                           mvt)
    assert out.dtype == tdt and nm.dtype == tdt and not nm.requires_grad
    dx, dg, db = torch.autograd.grad(out, (xt, gt, bt),
                                     torch.from_numpy(dy).to(tdt))
    assert dx.dtype == tdt and dg.dtype == tdt
    return [a.detach().float().numpy() for a in (out, nm, nv, dx, dg, db)]


@pytest.mark.parametrize("shape,axis", [((4, 6, 5, 7), 1), ((3, 5, 9), 1),
                                        ((6, 8), 1), ((2, 4, 6, 3), -1)],
                         ids=["nchw", "ncw", "nc", "nhwc"])
def test_bn_train_f32_matches_reference(shape, axis):
    data = _bn_inputs(shape, axis, seed=len(shape) * 10 + axis % 4)
    expect = _ref_bn(*data, axis, jnp.float32)
    got = _port_bn(*data, axis, torch.float32)
    for name, g, e in zip(("out", "mean", "var", "dx"), got[:4], expect[:4]):
        onp.testing.assert_allclose(g, e, atol=1e-5, rtol=1e-5, err_msg=name)
    for name, g, e in zip(("dgamma", "dbeta"), got[4:], expect[4:]):
        onp.testing.assert_allclose(g, e, atol=1e-4 * onp.abs(e).max(),
                                    rtol=1e-5, err_msg=name)


def test_bn_train_bf16_matches_reference():
    data = _bn_inputs((4, 6, 5, 7), 1, seed=3)
    data = [onp.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) for a in data]
    expect = _ref_bn(*data, 1, jnp.bfloat16)
    got = _port_bn(*data, 1, torch.bfloat16)
    for name, g, e in zip(("out", "mean", "var", "dx", "dgamma", "dbeta"),
                          got, expect):
        rtol = 2.0 ** -6 if name in ("mean", "var") else 2.0 ** -7
        onp.testing.assert_allclose(g, e, atol=1e-2, rtol=rtol, err_msg=name)


def test_bn_inference_matches_reference():
    x, gamma, beta, mm, mv, _ = _bn_inputs((3, 4, 5, 6), 1, seed=9)
    expect = ref_nn.batch_norm_inference(*(jnp.asarray(a) for a in (
        x, gamma, beta, mm, mv)), 1e-5, 1)
    got = port_nn.batch_norm_inference(*(torch.from_numpy(a) for a in (
        x, gamma, beta, mm, mv)), 1e-5, 1)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(expect), atol=1e-5,
                                rtol=1e-5)


def test_npx_batch_norm_modes_and_aux_updates():
    """Train mode comes from ``is_training()``; the running statistics
    are written at once, or deferred inside an aux scope; predict mode
    and ``use_global_stats`` leave them and use them."""
    x, gamma, beta, mm, mv, _ = (torch.from_numpy(a) for a in _bn_inputs(
        (4, 3, 5, 5), 1, seed=2))
    run_m, run_v = mm.clone(), mv.clone()
    with autograd.predict_mode():
        out = npx.batch_norm(x, gamma, beta, run_m, run_v)
    assert torch.equal(run_m, mm) and torch.equal(run_v, mv)
    expect = port_nn.batch_norm_inference(x, gamma, beta, mm, mv, 1e-5, 1)
    assert torch.equal(out, expect)
    with autograd.train_mode():
        with aux_update_scope() as aux:
            npx.batch_norm(x, gamma, beta, run_m, run_v)
        assert torch.equal(run_m, mm) and len(aux.updates) == 2
        npx.batch_norm(x, gamma, beta, run_m, run_v, use_global_stats=True)
        assert torch.equal(run_m, mm)
        npx.batch_norm(x, gamma, beta, run_m, run_v)
    new_m = 0.9 * mm + 0.1 * x.mean((0, 2, 3))
    onp.testing.assert_allclose(run_m.numpy(), new_m.numpy(), atol=1e-6)
    assert torch.equal(run_m, aux.updates[0][1])
    # fix_gamma: gamma of ones, and a zero gradient for it
    g = gamma.clone().requires_grad_()
    with autograd.record():
        out = npx.batch_norm(x, g, beta, run_m.clone(), run_v.clone(),
                             fix_gamma=True)
    out.sum().backward()
    assert torch.equal(g.grad, torch.zeros(3))


# ---------------------------------------------------------------------------
# convolution and pooling
# ---------------------------------------------------------------------------
def test_convolution_matches_reference():
    rng = onp.random.default_rng(4)
    x = rng.standard_normal((2, 6, 9, 11)).astype(onp.float32)
    w = rng.standard_normal((8, 3, 3, 3)).astype(onp.float32)
    b = rng.standard_normal(8).astype(onp.float32)
    kw = dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
              num_filter=8, num_group=2)
    expect = ref_nn.convolution(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), **kw)
    got = port_nn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), **kw)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(expect), atol=1e-5,
                                rtol=1e-5)
    # channels-last: the same weight, the NHWC view of the same data
    x_nhwc = onp.ascontiguousarray(x.transpose(0, 2, 3, 1))
    expect = ref_nn.convolution(jnp.asarray(x_nhwc), jnp.asarray(w),
                                jnp.asarray(b), layout="NHWC", **kw)
    got = port_nn.convolution(torch.from_numpy(x_nhwc), torch.from_numpy(w),
                              torch.from_numpy(b), layout="NHWC", **kw)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(expect), atol=1e-5,
                                rtol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        port_nn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                            layout="HWCN")


POOL_CASES = [
    dict(kernel=3, pool_type="max", stride=2, pad=1),
    dict(kernel=3, pool_type="max", stride=2, pad=1,
         pooling_convention="full"),
    dict(kernel=2, pool_type="avg", stride=2, pad=0),
    dict(kernel=3, pool_type="avg", stride=2, pad=1),
    dict(kernel=3, pool_type="avg", stride=2, pad=1, count_include_pad=False),
    dict(kernel=3, pool_type="avg", stride=2, pad=1,
         pooling_convention="full"),
    dict(kernel=3, pool_type="avg", stride=2, pad=1,
         pooling_convention="full", count_include_pad=False),
    dict(kernel=2, pool_type="sum", stride=2, pad=0,
         pooling_convention="full"),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="max"),
]


@pytest.mark.parametrize("kw", POOL_CASES, ids=range(len(POOL_CASES)))
def test_pooling_matches_reference(kw):
    x = onp.random.default_rng(8).standard_normal((2, 3, 8, 7)).astype(
        onp.float32)
    expect = ref_nn.pooling(jnp.asarray(x), **kw)
    got = port_nn.pooling(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == tuple(expect.shape)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(expect), atol=1e-5,
                                rtol=1e-5)
