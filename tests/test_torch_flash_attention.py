"""The port's flash attention (kernel B3) against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version
(`flash_attention_reference`); the JAX function runs its Pallas kernel
in interpret mode, as the JAX package's own tests run it.  Both get the
same numpy inputs.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.

Tolerance: f32 throughout, and both sides compute true-f32 scores and
an f32 softmax; they differ only in summation order (the Pallas kernel
accumulates block by block with an online softmax, the plain version
over whole rows), which at T <= 256 and D = 32 moves results by a few
ulps of values of order 1-10 — so atol = rtol = 2e-5, the JAX package's
own flash tolerance.  The dropout bits and masks are integer functions
and must match exactly.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as ref
from mxnet_tpu_torch.ops import flash_attention as port

torch.set_num_threads(1)

ATOL = RTOL = 2e-5
B, H, D = 2, 2, 32


def _inputs(t, seed):
    rng = onp.random.default_rng(seed)
    return [rng.standard_normal((B, H, t, D)).astype(onp.float32)
            for _ in range(3)]


def _mask(kind, t, seed):
    rng = onp.random.default_rng(seed + 1)
    if kind == "ragged":
        lens = onp.array([t // 3 + 5, t])
        return (onp.arange(t)[None, :] < lens[:, None]).astype(onp.int32)
    if kind == "holes":
        m = (rng.random((B, t)) > 0.4).astype(onp.int32)
        m[:, t - t // 4:] = 0       # padded tail on top of the holes
        m[:, 0] = 1
        return m
    if kind == "fully_masked_row":
        m = onp.ones((B, t), onp.int32)
        m[0] = 0
        m[1, t // 2:] = 0
        return m
    raise ValueError(kind)


def _bias(ndim, t, seed):
    rng = onp.random.default_rng(seed + 2)
    shape = {2: (t, t), 3: (H, t, t), 4: (B, 1, t, t)}[ndim]
    return rng.standard_normal(shape).astype(onp.float32)


CASES = {
    "no_mask": {},
    "ragged_mask": {"mask": "ragged"},
    "mask_with_holes": {"mask": "holes"},
    "fully_masked_row": {"mask": "fully_masked_row"},
    "causal": {"causal": True},
    "causal_ragged_mask": {"causal": True, "mask": "ragged"},
    "bias_2d": {"bias": 2},
    "bias_3d": {"bias": 3},
    "bias_4d": {"bias": 4},
    "dropout": {"dropout": 0.1},
    "dropout_mask_bias": {"dropout": 0.25, "mask": "ragged", "bias": 3},
}


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax_kernel(case, t):
    _check_against_jax(case, t)


@pytest.mark.parametrize("t", [37, 200, 305])
@pytest.mark.parametrize("case", ["ragged_mask", "causal",
                                  "dropout_mask_bias"])
def test_flash_matches_jax_kernel_at_any_length(case, t):
    """Lengths off the bucket grid, which the reference runs at its
    default block sizes and the CUDA kernel takes with a ragged last
    tile (held against the plain version on the card at T=305 by
    ``chip_smoke.py``)."""
    _check_against_jax(case, t)


def _check_against_jax(case, t):
    spec = CASES[case]
    seed = 1000 * len(case) + t
    q, k, v = _inputs(t, seed)
    kw_ref, kw_port = {}, {}
    if spec.get("causal"):
        kw_ref["causal"] = kw_port["causal"] = True
    if "mask" in spec:
        m = _mask(spec["mask"], t, seed)
        kw_ref["mask"], kw_port["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if "bias" in spec:
        bias = _bias(spec["bias"], t, seed)
        kw_ref["bias"], kw_port["bias"] = (jnp.asarray(bias),
                                           torch.from_numpy(bias))
    if "dropout" in spec:
        words = onp.array([seed, 977 * seed + 13], onp.uint32)
        kw_ref["dropout"] = kw_port["dropout"] = spec["dropout"]
        kw_ref["key"], kw_port["key"] = jnp.asarray(words), words.tolist()

    out_r, lse_r = ref.flash_attention_with_lse(
        *(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw_ref)
    out_p, lse_p = port.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw_port)
    assert out_p.dtype == torch.float32 and lse_p.shape == (B, H, t)
    onp.testing.assert_allclose(out_p.numpy(), onp.asarray(out_r),
                                atol=ATOL, rtol=RTOL)
    onp.testing.assert_allclose(lse_p.numpy(), onp.asarray(lse_r),
                                atol=ATOL, rtol=RTOL)
    if case == "fully_masked_row":
        assert (out_p[0] == 0).all()
        assert (lse_p[0] < port._MASKED_ROW).all()


def test_threefry_bit_identical():
    rng = onp.random.default_rng(7)
    words = rng.integers(0, 2 ** 32, size=(4, 4096), dtype=onp.uint64)
    expect = onp.asarray(ref._threefry2x32(
        *(jnp.asarray(w.astype(onp.uint32)) for w in words)))
    got = port._threefry2x32(*(torch.from_numpy(w.astype(onp.int64))
                               for w in words))
    onp.testing.assert_array_equal(got.numpy(), expect.astype(onp.int64))


@pytest.mark.parametrize("dropout", [0.1, 0.5])
def test_attn_dropout_mask_bit_identical(dropout):
    words = onp.array([0xDEADBEEF, 12345], onp.uint32)
    expect = onp.asarray(ref.attn_dropout_mask(
        jnp.asarray(words), 2, 3, 64, 96, dropout))
    got = port.attn_dropout_mask(words.tolist(), 2, 3, 64, 96, dropout)
    assert got.dtype == torch.float32
    onp.testing.assert_array_equal(got.numpy(), expect)


def test_kend_matches_reference():
    m = onp.zeros((4, 64), onp.int32)
    m[1, :17] = 1
    m[2, [3, 9, 40]] = 1        # holes do not shrink it
    m[3] = 1
    expect = onp.asarray(ref._kend(jnp.asarray(m)))
    got = port._kend(port._norm_mask(torch.from_numpy(m)))
    onp.testing.assert_array_equal(got.numpy(), expect)


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="one shape"):
        port.flash_attention(q, q, torch.zeros(1, 2, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        port.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="key-padding"):
        port.flash_attention(q, q, q, mask=torch.ones(1, 8, 8))
    with pytest.raises(ValueError, match="broadcast"):
        port.flash_attention(q, q, q, bias=torch.zeros(3, 8, 8))
    with pytest.raises(ValueError, match="dropout"):
        port.flash_attention(q, q, q, dropout=1.0)
    with pytest.raises(ValueError, match="key"):
        port.flash_attention(q, q, q, dropout=0.1)
