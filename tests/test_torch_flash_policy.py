"""What the flash path takes, and the port's flash at the head dims and
the type it now takes, against the JAX package.

- The model's ``use_flash="auto"`` policy (`flash_auto`) against the
  kernels' accepted set (`flash_supported`, which `_LaunchArgs` checks):
  the policy never picks flash for what the kernels refuse.
- The plain versions (`flash_attention_reference`,
  `flash_attention_backward_reference`, through the port's
  `torch.autograd.Function` on the CPU) at head_dim 40 and 96 and in
  f16, against the JAX package's `flash_attention_with_lse` and its
  custom VJP, whose Pallas kernels run in interpret mode with 32 x 32
  blocks, as `tests/test_torch_flash_attention_bwd.py` runs them.
- Zero padding along D (what the wrappers do for B4/B5, and for B3 in
  f32) against no padding, through the plain versions; and the wrappers
  handing the padded rows to the kernels and slicing the results back
  (the kernel library replaced by a fake that records its arguments).
- `BertModel(units=768, num_heads=8)` (head_dim 96) at one layer, in f32
  and f16, with ``use_flash=True`` and ``"auto"``, against the JAX model
  with the same weights carried across by `utils.convert`.

Tolerances.  f32: both sides true f32, differing in summation order
only: atol = rtol = 1e-4, the JAX package's own flash tolerance.  f16:
both sides round p * keep to f16 before the PV product (against their own
running maxima: two half-ulps, 2^-10 of a term), ds and p * keep before
the backward products, and the results once; where a rounding flips, a
result of order 1-4 moves by about one f16 ulp of it (2^-10 to 2^-8 in
absolute terms, 1e-3 to 4e-3): atol = rtol = 2e-3 for f16 outputs and
gradients (1e-3 measured).  The f16 BERT: f16 activations through one
layer of width 768 and two layer norms, which the two packages round at
different points: results of order 1-8 differ by an f16 ulp or two
(3.9e-3 measured at values near 5): atol = rtol = 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import BertModel as RefBert
from mxnet_tpu.ops import pallas_kernels as ref
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.models import transformer as tr
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

B, H, T = 2, 2, 128
BLOCKS = dict(block_q=32, block_k=32, interpret=True)
TOL = {"float32": 1e-4, "float16": 2e-3}
BERT_TOL = {"float32": 1e-4, "float16": 1e-2}


# ---------------------------------------------------------------------------
# the policy against the accepted set
# ---------------------------------------------------------------------------
def test_auto_takes_flash_where_the_reference_does():
    t = tr.FLASH_AUTO_MIN_T
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (16, 40, 64, 96, 128):
            assert tr.flash_auto("cuda", dtype, d, 8 * 12, t, None, False)
            assert tr.flash_auto("cuda", dtype, d, 8 * 12, t, 2, False)
    assert tr.flash_auto("cuda", torch.bfloat16, 64, 70000, t, 2, False)
    t_train = tr.FLASH_AUTO_MIN_T_TRAINING
    assert tr.flash_auto("cuda", torch.float16, 96, 96, t_train, 2, True)
    assert not tr.flash_auto("cuda", torch.float16, 96, 96, t_train, 2,
                             False)


def test_auto_refuses_what_it_should():
    t = tr.FLASH_AUTO_MIN_T
    ok = ("cuda", torch.bfloat16, 64, 96, t, 2, False)
    assert tr.flash_auto(*ok)
    for i, bad in ((0, "cpu"), (1, torch.float64),
                   (2, fa.FLASH_MAX_HEAD_DIM + 1), (2, 0),
                   (3, 2 ** 31), (4, t - 128), (4, t + 1), (5, 3)):
        args = list(ok)
        args[i] = bad
        assert not tr.flash_auto(*args), (i, bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_auto_never_picks_what_the_kernels_refuse(dtype):
    """For every combination the policy accepts, `_LaunchArgs` (the
    kernels' own check) accepts it too; and it refuses the rest."""
    t = tr.FLASH_AUTO_MIN_T
    for d in (1, 8, 40, 64, 96, 100, 128, 129, 160):
        for bh in (1, 96, 65536, 2 ** 31 - 1, 2 ** 31):
            q = torch.empty(bh, 1, 1, d, dtype=dtype, device="meta")
            picked = tr.flash_auto("cuda", dtype, d, bh, t, None, False)
            assert picked == fa.flash_supported(dtype, d, bh)
            if picked:
                fa._LaunchArgs(q, False, 1.0, None, None, 0.0, None)
            else:
                with pytest.raises((TypeError, ValueError)):
                    fa._LaunchArgs(q, False, 1.0, None, None, 0.0, None)


def test_model_asks_the_policy():
    """`MultiHeadAttention` takes flash under "auto" only through
    `flash_auto`: on the CPU never, whatever T."""
    mha = tr.MultiHeadAttention(96 * 2, 2)
    q = torch.empty(2, tr.FLASH_AUTO_MIN_T, 2, 96, device="meta")
    assert not mha._flash_now(q, None)
    assert tr.MultiHeadAttention(64, 2, use_flash=True)._flash_now(q, None)


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------
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
        lens = onp.array([0, 77])
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
@pytest.mark.parametrize("d,dtype", [(40, "float32"), (96, "float32"),
                                     (64, "float16"), (96, "float16")])
def test_plain_versions_match_jax(d, dtype, case):
    seed = d + len(case)
    q, k, v, g_out, g_lse = _arrays(d, dtype, seed)
    kw_ref, kw_port = _options(case, seed)
    expect = _jax(q, k, v, g_out, g_lse, kw_ref)
    got = _port(q, k, v, g_out, g_lse, kw_port)
    tol = TOL[dtype]
    for name, a, e in zip(("out", "lse", "dq", "dk", "dv"), got, expect):
        if name == "lse" and "mask" in kw_port:
            live = e > fa._MASKED_ROW
            a, e = a[live], e[live]
        onp.testing.assert_allclose(a, e, atol=tol, rtol=tol, err_msg=name)
    if "mask" in kw_port:                  # batch row 0 has no valid key
        assert not got[0][0].any() and not got[2][0].any()


# ---------------------------------------------------------------------------
# zero padding along D
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [40, 96])
def test_zero_padded_head_dim_gives_the_same_attention(d):
    """Zero columns add exact zeros to every product and sum (and to the
    row norms of B4/B5's tie test): padded q, k, v, out and dout with the
    true scale give the unpadded result and exact zeros in the padding."""
    pad = fa._HEAD_DIMS[[n >= d for n in fa._HEAD_DIMS].index(True)]
    rng = onp.random.default_rng(d)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (B, H, T, d)).astype(onp.float32)) for _ in range(4))
    lens = onp.array([T, 51])
    mask = torch.from_numpy((onp.arange(T)[None, :] < lens[:, None]
                             ).astype(onp.int32))
    kw = dict(mask=mask, causal=True, dropout=0.1, key=(5, 6),
              scale=d ** -0.5)

    def padded(x):
        return torch.nn.functional.pad(x, (0, pad - d))

    out, lse = fa.flash_attention_reference(q, k, v, **kw)
    out_p, lse_p = fa.flash_attention_reference(padded(q), padded(k),
                                                padded(v), **kw)
    torch.testing.assert_close(out_p[..., :d], out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    assert not out_p[..., d:].any()
    grads = fa.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                  **kw)
    grads_p = fa.flash_attention_backward_reference(
        padded(q), padded(k), padded(v), padded(out), lse, padded(dout),
        **kw)
    for g, g_p in zip(grads, grads_p):
        torch.testing.assert_close(g_p[..., :d], g, atol=1e-6, rtol=1e-6)
        assert not g_p[..., d:].any()
    # delta over the padded rows is the unpadded delta
    torch.testing.assert_close(fa._delta(padded(out), padded(dout), None),
                               fa._delta(out, dout, None), atol=1e-6,
                               rtol=1e-6)


class _FakeLib:
    """Stands in for the kernel libraries: records each call's
    arguments and launches nothing (outputs stay as allocated)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        lib = self

        class Entry:
            argtypes = None
            restype = None

            def __call__(self, *args):
                assert len(args) == len(self.argtypes)
                lib.calls.append((name, args))
                return 0

        entry = Entry()
        setattr(self, name, entry)
        return entry


@pytest.mark.parametrize("dtype,d,fwd_d,bwd_d", [
    (torch.bfloat16, 96, 96, 128), (torch.float16, 40, 40, 64),
    (torch.bfloat16, 36, 40, 64), (torch.float32, 96, 128, 128),
    (torch.float16, 64, 64, 64)])
def test_wrappers_pad_the_head_dim_and_slice_back(monkeypatch, dtype, d,
                                                  fwd_d, bwd_d):
    """B3 gets rows rounded up to 8 (16-bit types) or to the next of 16,
    32, 64, 128 (f32), B4/B5 to the next of 16, 32, 64, 128; each C entry
    gets the kernel's row length and the true head dim; the results come
    back at the true head dim."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name, declare: (
        declare(fake), fake)[1])
    monkeypatch.setattr(fa, "stream_of", lambda x: 0x77)
    x = torch.zeros(2, 3, 20, d, dtype=dtype)
    args = fa._LaunchArgs(x, False, d ** -0.5, None, None, 0.0, None)
    assert (args.fwd_d, args.bwd_d) == (fwd_d, bwd_d)
    out, lse = fa._launch_fwd(x, x, x, args)
    dq, dk, dv = fa._launch_backward(x, x, x, out, lse, x, None, args)
    for y in (out, dq, dk, dv):
        assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    (n0, a0), (n1, a1), (n2, a2) = fake.calls
    assert (n0, n1, n2) == ("flash_attention_fwd", "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv")
    # the tail: ..., batch, heads, seq, row length, true head dim, dtype
    # (then scale, causal, dropout, the seed words' pointer, threshold,
    # 1/keep, stream)
    for a, row in ((a0, fwd_d), (a1, bwd_d), (a2, bwd_d)):
        assert a[-13:-8] == (2, 3, 20, row, d)
        assert a[-8] == fa._DTYPES[dtype]


# ---------------------------------------------------------------------------
# BERT with head_dim 96, in f32 and f16
# ---------------------------------------------------------------------------
BERT_CFG = dict(vocab_size=100, units=768, hidden_size=256, num_layers=1,
                num_heads=8, max_length=T, dropout=0.0)


def _bert_pair(use_flash, dtype):
    net_r = RefBert(use_flash=use_flash, **BERT_CFG)
    net_r.initialize()
    net_r(mx.np.zeros((1, T), dtype="int32"))    # finish deferred init
    net_r.cast(dtype)
    net = BertModel(use_flash=use_flash, **BERT_CFG).initialize(ctx=cpu())
    net.cast(dtype)
    load_reference_params(net, {k: p.data().asnumpy().astype(onp.float32)
                                for k, p in net_r.collect_params().items()})
    return net_r, net


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("use_flash", [True, "auto"])
def test_bert_head_dim_96_matches_reference(use_flash, dtype):
    net_r, net = _bert_pair(use_flash, dtype)
    rng = onp.random.default_rng(17)
    tokens = rng.integers(0, BERT_CFG["vocab_size"], (2, T)).astype(onp.int32)
    segments = (onp.arange(T)[None, :] >= 40).astype(onp.int32).repeat(2, 0)
    valid = (onp.arange(T)[None, :] < onp.array([[T], [61]])).astype(
        onp.int32)
    args = (tokens, segments, valid)
    seq_r, pooled_r = net_r(*(mx.np.array(a, dtype="int32") for a in args))
    with torch.inference_mode():
        seq, pooled = net(*(torch.from_numpy(a) for a in args))
    assert seq.dtype == getattr(torch, dtype) and seq.shape == (2, T, 768)
    tol = BERT_TOL[dtype]
    for got, expect in ((seq, seq_r), (pooled, pooled_r)):
        onp.testing.assert_allclose(got.float().numpy(),
                                    expect.asnumpy().astype(onp.float32),
                                    atol=tol, rtol=tol)
