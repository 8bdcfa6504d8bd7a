"""The port's space-to-depth stem against the JAX package's.

Same numpy inputs (seeded) through `mxnet_tpu.ops.stem` and
`mxnet_tpu_torch.ops.stem` on the CPU.  The reference's B2 kernel
(`stem_conv_pallas`) runs as Pallas in interpret mode with explicit
tiles (no autotune cache is read); the port's kernel form
(`stem_conv_kernel`: B2, the packed conv without patches, with its
patch-free backward) runs through B2's plain version, because the
tensors lie on the CPU.

Tolerances, f32 throughout (true f32 products on both sides): the
packing and the fold move values without arithmetic and must agree
exactly; conv outputs and gradients sum 192 (stem) or up to 2 * 56 * 56
(weight gradient) products in other orders: atol = rtol = 1e-5 for
outputs of order 1-10, and 1e-5 x the largest magnitude plus rtol 1e-4
for weight gradients (sums over every output pixel).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as ref_gnn
from mxnet_tpu.ops import stem as ref_stem
from mxnet_tpu.ops.legacy_math import space_to_depth as ref_s2d
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon import nn as gnn
from mxnet_tpu_torch.ops import stem

torch.set_num_threads(1)


def _inputs(b=2, c_in=3, hw=32, c_out=16, seed=0):
    rng = onp.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, c_in, hw, hw)).astype(onp.float32)
    w7 = (rng.standard_normal((c_out, c_in, 7, 7)) * 0.1).astype(onp.float32)
    return x, w7


def test_packing_and_fold_match_reference_exactly():
    x, w7 = _inputs()
    onp.testing.assert_array_equal(
        stem.space_to_depth2(torch.from_numpy(x)).numpy(),
        onp.asarray(ref_stem.space_to_depth2(jnp.asarray(x))))
    onp.testing.assert_array_equal(
        stem.space_to_depth(torch.from_numpy(x), 4).numpy(),
        onp.asarray(ref_s2d(jnp.asarray(x), 4)))
    onp.testing.assert_array_equal(
        stem.fold_stem_kernel(torch.from_numpy(w7)).numpy(),
        onp.asarray(ref_stem.fold_stem_kernel(jnp.asarray(w7))))
    with pytest.raises(ValueError, match="7x7"):
        stem.fold_stem_kernel(torch.zeros(4, 3, 5, 5))


def test_patches_order_matches_the_folded_kernel():
    """im2col channel order (c, kh, kw): the patches times the flattened
    folded kernel give the plain conv."""
    x, w7 = _inputs(b=1, hw=12, c_out=5, seed=1)
    xs = stem.space_to_depth2(torch.from_numpy(x))
    wf = stem.fold_stem_kernel(torch.from_numpy(w7))
    flat = stem.stem_patches(xs)
    assert flat.shape == (36, 192)
    out = (flat @ wf.reshape(5, -1).t()).reshape(1, 6, 6, 5).permute(
        0, 3, 1, 2)
    onp.testing.assert_allclose(out.numpy(), stem.stem_conv(xs, wf).numpy(),
                                atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["plain", "kernel"])
def test_stem_forward_and_grads_match_pallas(form):
    x, w7 = _inputs(seed=2)
    xs_r = ref_stem.space_to_depth2(jnp.asarray(x))

    def ref_fn(xs, w):
        return ref_stem.stem_conv_pallas(xs, ref_stem.fold_stem_kernel(w),
                                         tm=256, tn=16, interpret=True)

    out_r, vjp = jax.vjp(ref_fn, xs_r, jnp.asarray(w7))
    ct = onp.random.default_rng(3).standard_normal(out_r.shape).astype(
        onp.float32)
    dxs_r, dw_r = vjp(jnp.asarray(ct))

    xs = stem.space_to_depth2(torch.from_numpy(x)).requires_grad_()
    w = torch.from_numpy(w7).requires_grad_()
    fn = stem.stem_conv if form == "plain" else stem.stem_conv_kernel
    out = fn(xs, stem.fold_stem_kernel(w))
    assert out.shape == (2, 16, 16, 16) and out.is_contiguous()
    dxs, dw = torch.autograd.grad(out, (xs, w), torch.from_numpy(ct))
    onp.testing.assert_allclose(out.detach().numpy(), onp.asarray(out_r),
                                atol=1e-5, rtol=1e-5)
    onp.testing.assert_allclose(dxs.numpy(), onp.asarray(dxs_r), atol=1e-5,
                                rtol=1e-5)
    scale = float(onp.abs(onp.asarray(dw_r)).max())
    onp.testing.assert_allclose(dw.numpy(), onp.asarray(dw_r),
                                atol=1e-5 * scale, rtol=1e-4)
    # the folded stem is the 7x7/stride-2 conv
    onp.testing.assert_allclose(
        out.detach().numpy(),
        stem.reference_stem_conv(torch.from_numpy(x),
                                 torch.from_numpy(w7)).numpy(),
        atol=1e-5, rtol=1e-5)


def test_stem_matmul_plain_rounds_once():
    """B2's plain version: f32 products and sums, one rounding to the
    input dtype; its wrapper checks its arguments."""
    rng = onp.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((37, 192)).astype(onp.float32))
    w = torch.from_numpy(rng.standard_normal((192, 24)).astype(onp.float32))
    got = stem.stem_matmul(a.bfloat16(), w.bfloat16())
    expect = (a.bfloat16().double() @ w.bfloat16().double()).bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape == (37, 24)
    assert torch.equal(got, expect)
    with pytest.raises(ValueError, match="one device"):
        stem.stem_matmul(a, w[:100])
    with pytest.raises(ValueError, match="unsupported device"):
        stem.stem_matmul(a.to("meta"), w.to("meta"))


def _ref_stem_blocks(w7):
    s2d = ref_gnn.SpaceToDepthStem(w7.shape[0], in_channels=3)
    conv = ref_gnn.Conv2D(w7.shape[0], 7, 2, 3, use_bias=False,
                          in_channels=3)
    for blk in (s2d, conv):
        blk.initialize()
        blk.collect_params()["weight"].set_data(mx.np.array(w7))
    return s2d, conv


def test_space_to_depth_stem_layer_matches_conv2d_in_both_packages():
    x, w7 = _inputs(c_out=64, seed=5)
    s2d_r, conv_r = _ref_stem_blocks(w7)
    xs_np = onp.array(ref_stem.space_to_depth2(jnp.asarray(x)))
    out_s2d_r = s2d_r(mx.np.array(xs_np)).asnumpy()
    out_conv_r = conv_r(mx.np.array(x)).asnumpy()

    s2d = gnn.SpaceToDepthStem(64, in_channels=3)
    conv = gnn.Conv2D(64, 7, 2, 3, use_bias=False)
    for blk in (s2d, conv):
        blk.initialize(ctx=cpu())
        blk.collect_params()["weight"].set_data(w7)
    assert conv.collect_params()["weight"].shape == (64, 3, 7, 7)
    with torch.no_grad():
        out_s2d = s2d(torch.from_numpy(xs_np)).numpy()
        out_conv = conv(torch.from_numpy(x)).numpy()
    for got in (out_s2d, out_conv):
        for expect in (out_s2d_r, out_conv_r):
            onp.testing.assert_allclose(got, expect, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="packed"):
        s2d(torch.from_numpy(x))


def _b2_allowance(xs, wf, ct, dtype):
    """Allowances of the kernel form against the reference, elementwise,
    for out, dxs and dwf: f32 sums of K products in two orders differ by
    at most 2 K 2^-24 of the sum of |products| (the same conv, transposed
    conv and weight gradient taken on absolute values); in bf16 each
    side rounds its results once (half an ulp, 2^-8 of the value), and
    the reference also rounds each patch gradient to bf16 before the
    transposed im2col sums them (2^-8 of each term, so 2^-8 of the sum
    of |terms| more for dxs)."""
    k = wf[0].numel()
    xa, wa, ca = xs.float().abs(), wf.float().abs(), ct.float().abs()
    out = stem.stem_conv(xa, wa)
    padded = (xs.shape[0], xs.shape[1], xs.shape[2] + 3, xs.shape[3] + 3)
    dx = torch.nn.grad.conv2d_input(padded, wa, ca)[:, :, 2:-1, 2:-1]
    dw = torch.nn.grad.conv2d_weight(
        torch.nn.functional.pad(xa, (2, 1, 2, 1)), wf.shape, ca)
    depth = 2 * k * 2.0 ** -24
    allow = [depth * out, 16 * depth * dx, depth * xs.shape[0] * dw]
    if dtype == torch.bfloat16:
        allow = [allow[0] + 2.0 ** -7 * out, allow[1] + 2.0 ** -7 * dx,
                 allow[2] + 2.0 ** -7 * dw]
    return [a + 1e-6 for a in allow]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(30, 34), (32, 32)])
def test_b2_kernel_form_and_backward_match_pallas(hw, dtype):
    """B2's plain version (`stem_conv_b2_reference`, as `stem_conv_kernel`
    runs it on the CPU) and the patch-free backward (`_StemConv`) against
    the JAX package's `stem_conv_pallas` in interpret mode (its forward is
    the Pallas matmul over the patches, its backward `_stem_matmul_bwd`'s
    two f32 products), at C_out = 40 (a partial channel tile) and at a
    ragged packed shape (15 x 17)."""
    rng = onp.random.default_rng(hw[0] + hw[1])
    x = rng.uniform(-1, 1, (2, 3, *hw)).astype(onp.float32)
    w7 = (rng.standard_normal((40, 3, 7, 7)) * 0.1).astype(onp.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xs_r = ref_stem.space_to_depth2(jnp.asarray(x).astype(jdt))
    wf_r = ref_stem.fold_stem_kernel(jnp.asarray(w7).astype(jdt))
    out_r, vjp = jax.vjp(
        lambda a, b: ref_stem.stem_conv_pallas(a, b, tm=256, tn=16,
                                               interpret=True), xs_r, wf_r)
    ct = rng.standard_normal(out_r.shape).astype(onp.float32)
    dxs_r, dwf_r = vjp(jnp.asarray(ct).astype(jdt))

    xs = stem.space_to_depth2(torch.from_numpy(x).to(dtype)).requires_grad_()
    wf = stem.fold_stem_kernel(torch.from_numpy(w7).to(dtype)
                               ).requires_grad_()
    out = stem.stem_conv_kernel(xs, wf)
    assert out.shape == (2, 40, hw[0] // 2, hw[1] // 2)
    assert out.dtype == dtype and out.is_contiguous()
    assert torch.equal(out, stem.stem_conv_b2_reference(xs, wf))
    ct_t = torch.from_numpy(ct).to(dtype)
    dxs, dwf = torch.autograd.grad(out, (xs, wf), ct_t)
    assert dxs.dtype == dwf.dtype == dtype
    allow = _b2_allowance(xs.detach(), wf.detach(), ct_t, dtype)
    for name, got, expect, a in zip(("out", "dxs", "dwf"), (out, dxs, dwf),
                                    (out_r, dxs_r, dwf_r), allow):
        expect = torch.from_numpy(onp.array(expect.astype(jnp.float32)))
        err = (got.detach().float() - expect).abs()
        assert bool((err <= a).all()), (name, float((err / a).max()))


def test_b2_wrapper_checks_its_arguments():
    xs = torch.zeros(1, 12, 5, 6)
    with pytest.raises(ValueError, match="on one device"):
        stem.stem_conv_b2(xs, torch.zeros(8, 12, 3, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        stem.stem_conv_b2(xs.to("meta"), torch.zeros(8, 12, 4, 4,
                                                     device="meta"))
    got = stem.stem_conv_b2(xs + 1, torch.ones(8, 12, 4, 4))
    assert got.shape == (1, 8, 5, 6) and torch.equal(
        got, stem.stem_conv(xs + 1, torch.ones(8, 12, 4, 4)))
