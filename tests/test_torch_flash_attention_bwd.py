"""The port's flash-attention backward (kernels B4, B5) against the JAX
package's.

On the CPU the port's `torch.autograd.Function` runs the plain PyTorch
versions (`flash_attention_reference` forward,
`flash_attention_backward_reference` backward); the JAX side takes
``jax.grad`` of its `flash_attention` / `flash_attention_with_lse`, whose
custom VJP runs the Pallas kernels `_bwd_dq_kernel` and
`_bwd_dkv_kernel` in interpret mode with explicit 32 x 32 blocks, so
that at T = 128 each kernel walks a 4 x 4 grid of tiles.  Both get the
same numpy inputs and the same upstream cotangents.  The CUDA kernels
are held against the plain backward on the card by ``chip_smoke.py``.

Tolerance: f32 throughout, true-f32 products on both sides; the
gradients differ only in summation order (block by block in the Pallas
kernels, whole rows in the plain version), a few ulps of values of
order 0.1-10 at T = 128 and D = 32, so atol = rtol = 1e-4, the JAX
package's own flash-gradient tolerance.  Where the reference writes
exact zeros (a batch row with no valid key, keys past the last valid
one) the port must too.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as ref
from mxnet_tpu_torch.ops import flash_attention as port

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B, H, T, D = 2, 2, 128, 32
BLOCKS = dict(block_q=32, block_k=32, interpret=True)


def _arrays(seed):
    rng = onp.random.default_rng(seed)
    q, k, v, g_out = (rng.standard_normal((B, H, T, D)).astype(onp.float32)
                      for _ in range(4))
    g_lse = rng.standard_normal((B, H, T)).astype(onp.float32)
    return q, k, v, g_out, g_lse


def _ragged_mask():
    """Batch row 0 has no valid key; row 1 is valid up to 77 (a ragged
    tail inside the third 32-key tile)."""
    lens = onp.array([0, 77])
    return (onp.arange(T)[None, :] < lens[:, None]).astype(onp.int32)


CASES = {
    "no_mask": {},
    "ragged_mask": {"mask": True},
    "causal": {"causal": True},
    "bias": {"bias": True},
    "dropout": {"dropout": 0.1},
    "dlse": {"lse": True},
    "dlse_mask_dropout": {"lse": True, "mask": True, "dropout": 0.1},
}


def _kwargs(spec, seed):
    kw_ref, kw_port = {}, {}
    if spec.get("causal"):
        kw_ref["causal"] = kw_port["causal"] = True
    if spec.get("mask"):
        m = _ragged_mask()
        kw_ref["mask"], kw_port["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if spec.get("bias"):
        bias = onp.random.default_rng(seed + 5).standard_normal(
            (H, T, T)).astype(onp.float32)
        kw_ref["bias"], kw_port["bias"] = (jnp.asarray(bias),
                                           torch.from_numpy(bias))
    if "dropout" in spec:
        words = onp.array([seed, 977 * seed + 13], onp.uint32)
        kw_ref["dropout"] = kw_port["dropout"] = spec["dropout"]
        kw_ref["key"], kw_port["key"] = jnp.asarray(words), words.tolist()
    return kw_ref, kw_port


def _jax_grads(q, k, v, g_out, g_lse, with_lse, kw):
    def loss(qd, kd, vd):
        if with_lse:
            out, lse = ref.flash_attention_with_lse(qd, kd, vd, **BLOCKS,
                                                    **kw)
            return jnp.sum(out * g_out) + jnp.sum(lse * g_lse)
        out = ref.flash_attention(qd, kd, vd, **BLOCKS, **kw)
        return jnp.sum(out * g_out)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [onp.asarray(g) for g in grads]


def _port_grads(q, k, v, g_out, g_lse, with_lse, kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    if with_lse:
        out, lse = port.flash_attention_with_lse(qt, kt, vt, **kw)
        loss = (out * torch.from_numpy(g_out)).sum() + \
            (lse * torch.from_numpy(g_lse)).sum()
    else:
        out = port.flash_attention(qt, kt, vt, **kw)
        loss = (out * torch.from_numpy(g_out)).sum()
    loss.backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_jax(case):
    spec = CASES[case]
    seed = 31 * len(case) + 7
    q, k, v, g_out, g_lse = _arrays(seed)
    kw_ref, kw_port = _kwargs(spec, seed)
    with_lse = spec.get("lse", False)
    expect = _jax_grads(q, k, v, g_out, g_lse, with_lse, kw_ref)
    got = _port_grads(q, k, v, g_out, g_lse, with_lse, kw_port)
    for name, a, e in zip(("dq", "dk", "dv"), got, expect):
        onp.testing.assert_allclose(a, e, atol=ATOL, rtol=RTOL,
                                    err_msg=name)
    if spec.get("mask"):
        dq, dk, dv = got
        assert (dq[0] == 0).all()                 # the fully masked row
        assert (dk[:, :, 77:] == 0).all() and (dv[:, :, 77:] == 0).all()
        assert (dk[0] == 0).all() and (dv[0] == 0).all()


@pytest.mark.parametrize("case", ["ragged_mask", "causal", "dropout",
                                  "dlse_mask_dropout"])
def test_backward_reference_on_saved_forward(case):
    """`flash_attention_backward_reference` called directly on a saved
    forward gives what the autograd Function gives."""
    spec = CASES[case]
    seed = 13 * len(case)
    q, k, v, g_out, g_lse = _arrays(seed)
    _kw_ref, kw = _kwargs(spec, seed)
    with_lse = spec.get("lse", False)
    qt, kt, vt, dout = (torch.from_numpy(a) for a in (q, k, v, g_out))
    out, lse = port.flash_attention_reference(qt, kt, vt, **kw)
    dq, dk, dv = port.flash_attention_backward_reference(
        qt, kt, vt, out, lse, dout,
        dlse=torch.from_numpy(g_lse) if with_lse else None, **kw)
    expect = _port_grads(q, k, v, g_out, g_lse, with_lse, kw)
    for a, e in zip((dq, dk, dv), expect):
        onp.testing.assert_array_equal(a.numpy(), e)


def test_backward_matches_autograd_of_dense_softmax():
    """With neither mask nor dropout, the plain backward is the gradient
    of the dense softmax attention that torch's autograd takes."""
    q, k, v, g_out, _ = _arrays(3)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * D ** -0.5
    out = torch.matmul(torch.softmax(s, -1), vt)
    (out * torch.from_numpy(g_out)).sum().backward()
    got = _port_grads(q, k, v, g_out, None, False, {})
    for a, t in zip(got, (qt, kt, vt)):
        onp.testing.assert_allclose(a, t.grad.numpy(), atol=ATOL, rtol=RTOL)


def test_bf16_rounds_ds_and_p_where_the_kernels_do():
    """In bf16 the plain backward rounds ds and p*keep to bf16 before
    their products; an f32 backward of the same bf16 inputs differs from
    it by those roundings only."""
    q, k, v, g_out, _ = _arrays(11)
    qb, kb, vb, db = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g_out))
    out, lse = port.flash_attention_reference(qb, kb, vb)
    got = port.flash_attention_backward_reference(qb, kb, vb, out, lse, db)
    assert all(g.dtype == torch.bfloat16 for g in got)
    f32 = port.flash_attention_backward_reference(
        qb.float(), kb.float(), vb.float(), out.float(), lse, db.float())
    for a, e in zip(got, f32):
        # bf16 keeps 8 bits: one rounding of ds (or p) and one of the
        # result, each up to 2^-8 relative, over sums of 128 terms
        torch.testing.assert_close(a.float(), e, atol=5e-2, rtol=2e-2)


def test_no_gradient_to_mask_bias_or_seed():
    q, k, v, g_out, _ = _arrays(5)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    bias = torch.zeros(H, T, T, requires_grad=True)
    out = port.flash_attention(qt, kt, vt, bias=bias,
                               mask=torch.from_numpy(_ragged_mask()),
                               dropout=0.1, key=[1, 2])
    (out * torch.from_numpy(g_out)).sum().backward()
    assert bias.grad is None
    assert qt.grad is not None and kt.grad is not None and vt.grad is not None


def test_counts_no_launch_on_the_cpu():
    before = (port.FLASH_FWD.launches, port.FLASH_BWD_DQ.launches,
              port.FLASH_BWD_DKV.launches)
    _port_grads(*_arrays(1), False, {})
    assert (port.FLASH_FWD.launches, port.FLASH_BWD_DQ.launches,
            port.FLASH_BWD_DKV.launches) == before
