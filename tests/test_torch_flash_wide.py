"""The port's flash attention at head dims past 128, against the JAX
package.

- The plain versions (`flash_attention_reference`,
  `flash_attention_backward_reference`, through the port's
  `torch.autograd.Function` on the CPU) at head_dim 160, 200 and 256 in
  f32 and at 256 in f16, with a key-padding mask and dropout 0.1, and
  causal with an additive bias, against the JAX package's
  `flash_attention_with_lse` and its custom VJP, whose Pallas kernels run
  in interpret mode with 32 x 32 blocks (T = 64).  These are the
  functions the chunked CUDA kernels are held against on the card.
- What the kernels take: `flash_supported` and the model's ``"auto"``
  policy accept every head dim up to `FLASH_MAX_HEAD_DIM`, as the
  reference's kernel takes any head dim.
- The wrappers, with the kernel library replaced by a fake that records
  its arguments: past 128 they hand the rows over unpadded, and every
  entry gets a pointer to the two dropout seed words, which equal
  `_seed_words(key)` (host words copied to the inputs' device, or a
  seed-table slot passed as it is).  In bf16 and f16 at head dims 136
  and 200 (no multiple of 16: the chunked tensor-core kernels zero-fill
  their tiles past D), the forward entry and both backward entries get
  the inputs' own rows, the true head dim as row length (and as
  delta's), the type and the seed words by pointer.

Tolerances, as in `tests/test_torch_flash_policy.py`: f32 on both sides
differs only in summation order (atol = rtol = 1e-4); f16 rounds p *
keep, ds and the results at the same points on both sides, and a flipped
rounding moves a result of order 1 by about one f16 ulp (atol = rtol =
2e-3).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as ref
from mxnet_tpu_torch.models import transformer as tr
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

B, H, T = 2, 2, 64
BLOCKS = dict(block_q=32, block_k=32, interpret=True)
TOL = {"float32": 1e-4, "float16": 2e-3}


def _arrays(d, dtype, seed):
    rng = onp.random.default_rng(seed)
    q, k, v, g_out = (rng.standard_normal((B, H, T, d)).astype(onp.float32)
                      for _ in range(4))
    g_lse = rng.standard_normal((B, H, T)).astype(onp.float32)
    if dtype == "float16":
        q, k, v, g_out = (a.astype(onp.float16) for a in (q, k, v, g_out))
    return q, k, v, g_out, g_lse


def _options(case, seed):
    kw_ref, kw_port = {}, {}
    if case == "mask_dropout":
        lens = onp.array([T, 37])
        m = (onp.arange(T)[None, :] < lens[:, None]).astype(onp.int32)
        kw_ref["mask"], kw_port["mask"] = jnp.asarray(m), torch.from_numpy(m)
        words = onp.array([seed, 977 * seed + 13], onp.uint32)
        kw_ref["dropout"] = kw_port["dropout"] = 0.1
        kw_ref["key"], kw_port["key"] = jnp.asarray(words), words.tolist()
    else:                                  # causal_bias
        kw_ref["causal"] = kw_port["causal"] = True
        bias = onp.random.default_rng(seed + 5).standard_normal(
            (H, T, T)).astype(onp.float32)
        kw_ref["bias"], kw_port["bias"] = (jnp.asarray(bias),
                                           torch.from_numpy(bias))
    return kw_ref, kw_port


def _jax(q, k, v, g_out, g_lse, kw):
    def loss(qd, kd, vd):
        out, lse = ref.flash_attention_with_lse(qd, kd, vd, **BLOCKS, **kw)
        return (jnp.sum(out.astype(jnp.float32) * g_out.astype(onp.float32))
                + jnp.sum(lse * g_lse)), (out, lse)

    grads, (out, lse) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [onp.asarray(x).astype(onp.float32)
            for x in (out, lse, *grads)]


def _port(q, k, v, g_out, g_lse, kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(qt, kt, vt, **kw)
    loss = (out.float() * torch.from_numpy(g_out).float()).sum() + \
        (lse * torch.from_numpy(g_lse)).sum()
    loss.backward()
    return [x.detach().float().numpy()
            for x in (out, lse, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("case", ["mask_dropout", "causal_bias"])
@pytest.mark.parametrize("d,dtype", [(160, "float32"), (200, "float32"),
                                     (256, "float32"), (256, "float16")])
def test_plain_versions_match_jax_past_128(d, dtype, case):
    seed = d + len(case)
    q, k, v, g_out, g_lse = _arrays(d, dtype, seed)
    kw_ref, kw_port = _options(case, seed)
    expect = _jax(q, k, v, g_out, g_lse, kw_ref)
    got = _port(q, k, v, g_out, g_lse, kw_port)
    tol = TOL[dtype]
    for name, a, e in zip(("out", "lse", "dq", "dk", "dv"), got, expect):
        assert a.shape == e.shape
        onp.testing.assert_allclose(a, e, atol=tol, rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# what the kernels take
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernels_and_policy_take_head_dims_past_128(dtype):
    top = fa.FLASH_MAX_HEAD_DIM
    t = tr.FLASH_AUTO_MIN_T
    for d in (129, 136, 160, 200, 256, 512, 4096, top):
        assert fa.flash_supported(dtype, d, 96)
        assert tr.flash_auto("cuda", dtype, d, 96, t, 2, False)
        assert tr.flash_auto("cuda", dtype, d, 96, tr.FLASH_AUTO_MIN_T_TRAINING,
                             None, True)
        assert not tr.flash_auto("cuda", dtype, d, 96, t - 128, 2, False)
        q = torch.empty(8, 12, 1, d, dtype=dtype, device="meta")
        args = fa._LaunchArgs(q, False, 1.0, None, None, 0.0, None)
        assert (args.fwd_d, args.bwd_d) == (d, d)   # unpadded
    assert not fa.flash_supported(dtype, top + 1, 96)
    assert not tr.flash_auto("cuda", dtype, top + 1, 96, t, 2, False)


def test_model_takes_flash_at_head_dim_256():
    """`MultiHeadAttention` with 4 heads of 256 (units 1024) runs flash
    when forced, and under "auto" past the crossover on a CUDA tensor."""
    mha = tr.MultiHeadAttention(1024, 4, use_flash="auto")
    q = torch.empty(2, tr.FLASH_AUTO_MIN_T, 4, 256, device="meta")
    assert not mha._flash_now(q, None)              # not on a CUDA tensor
    assert tr.flash_auto("cuda", torch.bfloat16, 256, 8, tr.FLASH_AUTO_MIN_T,
                         None, False)
    assert tr.MultiHeadAttention(1024, 4, use_flash=True)._flash_now(q, None)


# ---------------------------------------------------------------------------
# the wrappers against a fake kernel library
# ---------------------------------------------------------------------------
class _FakeLib:
    """Stands in for the kernel libraries: records each call's arguments
    (and the two words behind its seed pointer) and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        lib = self

        class Entry:
            argtypes = None
            restype = None

            def __call__(self, *args):
                assert len(args) == len(self.argtypes)
                ptr = args[-4]
                words = None if ptr is None else tuple(
                    (ctypes.c_uint32 * 2).from_address(ptr))
                lib.calls.append((name, args, words))
                return 0

        entry = Entry()
        setattr(self, name, entry)
        return entry


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name, declare: (
        declare(lib), lib)[1])
    monkeypatch.setattr(fa, "stream_of", lambda x: 0x77)
    return lib


@pytest.mark.parametrize("key", [[0xDEADBEEF, 12345], (7,),
                                 onp.array([1, 2 ** 32 - 1], onp.uint32)])
@pytest.mark.parametrize("d", [64, 96, 256])
def test_wrappers_pass_the_seed_words_by_pointer(fake, key, d):
    x = torch.zeros(2, 3, 40, d, dtype=torch.bfloat16)
    args = fa._LaunchArgs(x, False, d ** -0.5, None, None, 0.1, key)
    out, lse = fa._launch_fwd(x, x, x, args)
    fa._launch_backward(x, x, x, out, lse, x, None, args)
    names = [c[0] for c in fake.calls]
    assert names == ["flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"]
    for _, a, words in fake.calls:
        assert words == tuple(fa._seed_words(key))
        assert a[-4] == args.seed.data_ptr()
        assert a[-9] == d                         # the true head dim
    if d > 128:                                   # rows go over unpadded
        assert all(a[-10] == d for _, a, _ in fake.calls)


def test_a_seed_table_slot_is_passed_as_it_is(fake):
    """A seed-table slot (int32 words on the inputs' device) reaches the
    kernels without a copy: the graph of a captured step points at it."""
    slot = torch.tensor([[5, -3], [11, 12]], dtype=torch.int32)[1]
    x = torch.zeros(1, 2, 16, 256, dtype=torch.float16)
    args = fa._LaunchArgs(x, True, 0.1, None, None, 0.2, slot)
    assert args.seed is slot
    fa._launch_fwd(x, x, x, args)
    (_, a, words), = fake.calls
    assert a[-4] == slot.data_ptr() and words == (11, 12)


def test_no_dropout_passes_no_seed(fake):
    x = torch.zeros(1, 2, 16, 300, dtype=torch.float32)
    args = fa._LaunchArgs(x, False, 0.1, None, None, 0.0, None)
    fa._launch_fwd(x, x, x, args)
    (_, a, words), = fake.calls
    assert a[-4] is None and words is None and a[-6] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [136, 200])
def test_backward_takes_16_bit_rows_past_128_as_they_are(fake, dtype, d):
    gen = torch.Generator().manual_seed(d)
    q, k, v, dout = (torch.randn(2, 3, 40, d, generator=gen).to(dtype)
                     for _ in range(4))
    out = torch.zeros_like(q)
    lse = torch.zeros(2, 3, 40)
    args = fa._LaunchArgs(q, True, d ** -0.5, None, None, 0.1, [9, 2 ** 31])
    dq, dk, dv = fa._launch_backward(q, k, v, out, lse, dout, None, args)
    assert [c[0] for c in fake.calls] == ["flash_attention_bwd_dq",
                                          "flash_attention_bwd_dkv"]
    for _, a, words in fake.calls:
        assert a[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         dout.data_ptr())              # no padded copies
        assert (a[-10], a[-9]) == (d, d)               # rows unpadded
        assert a[-8] == fa._DTYPES[dtype]
        assert a[-4] == args.seed.data_ptr() and words == (9, 2 ** 31)
    for g in (dq, dk, dv):
        assert g.shape == q.shape and g.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [136, 200])
def test_forward_takes_16_bit_rows_past_128_as_they_are(fake, dtype, d):
    gen = torch.Generator().manual_seed(d + 1)
    q, k, v = (torch.randn(2, 3, 40, d, generator=gen).to(dtype)
               for _ in range(3))
    args = fa._LaunchArgs(q, True, d ** -0.5, None, None, 0.1,
                          [4, 2 ** 32 - 5])
    out, lse = fa._launch_fwd(q, k, v, args)
    (name, a, words), = fake.calls
    assert name == "flash_attention_fwd"
    assert a[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())  # no copies
    assert a[3] == out.data_ptr() and a[4] == lse.data_ptr()
    assert (a[-10], a[-9]) == (d, d)               # rows unpadded
    assert a[-8] == fa._DTYPES[dtype]
    assert a[-4] == args.seed.data_ptr() and words == (4, 2 ** 32 - 5)
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == (2, 3, 40) and lse.dtype == torch.float32
