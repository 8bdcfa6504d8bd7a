"""The contract between the port's backward kernels B4 and B5, on the CPU.

B4 (dq) draws the dropout bits once and writes them as packed int32 words
(B, H, T, ceil(T/32)), bit j of word w in row q = keep(q, 32w + j), with
delta = rowsum(dO * out) - dlse; B5 (dk, dv) reads both instead of drawing
the bits again.  Here: the plain version of the packed mask
(`keep_words_reference`) against `attn_dropout_mask` and against the JAX
package's `_keep_scale` bits; the bits of pairs whose p is 0 are unused by
the plain B5 (`flash_attention_bwd_dkv_reference`), which matches the plain
backward exactly; and the launch path with a fake kernel library in place
of the built one (launch order, shared buffers, argument counts, refusals).
The kernels themselves run on the card: `chip_smoke.py` phase 2b holds the
words B4 writes against `keep_words_reference` and the gradients against
`flash_attention_backward_reference`.
"""
import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as ref
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = (0x1234ABCD, 0x9876)
DROPOUT = 0.1


def _words_as_uint(words):
    return words.to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("t", [45, 128])
def test_keep_words_match_attn_dropout_mask(t):
    """Every bit of the packed words is the keep bit of its pair, and the
    bits past T in the last word are 0."""
    b, h = 2, 3
    words = fa.keep_words_reference(KEY, b, h, t, DROPOUT)
    assert words.shape == (b, h, t, (t + 31) // 32)
    assert words.dtype == torch.int32
    keep = fa.attn_dropout_mask(KEY, b, h, t, t, DROPOUT) != 0
    u = _words_as_uint(words)
    for q_pos, k_pos in [(0, 0), (1, 31), (t - 1, t - 1), (t // 2, 32),
                         (3, t - 2)]:
        bit = (u[..., q_pos, k_pos // 32] >> (k_pos % 32)) & 1
        assert torch.equal(bit.bool(), keep[..., q_pos, k_pos])
    assert torch.equal(fa._unpack_bits(words, t), keep)
    if t % 32:
        assert not bool((u[..., -1] >> (t % 32)).any())
    # about 1 - DROPOUT of the bits are set
    assert abs(keep.float().mean().item() - (1 - DROPOUT)) < 0.02


@pytest.mark.parametrize("t", [45, 128])
def test_keep_words_match_jax_keep_scale(t):
    """The words hold the bits of the reference's `_keep_scale` for one
    (T, T) block of each batch*head, and of its `attn_dropout_mask`."""
    b, h = 2, 2
    thr = ref._keep_threshold(1.0 - DROPOUT)
    seed = jnp.asarray(onp.array(KEY, onp.uint32))
    keep = fa._unpack_bits(fa.keep_words_reference(KEY, b, h, t, DROPOUT), t)
    for bh in range(b * h):
        ks = ref._keep_scale(seed, jnp.int32(bh), 0, 0, t, t, (t, t), thr,
                             1.0 / (1.0 - DROPOUT))
        onp.testing.assert_array_equal(onp.asarray(ks) != 0,
                                       keep.reshape(b * h, t, t)[bh].numpy())
    dense = onp.asarray(ref.attn_dropout_mask(onp.array(KEY, onp.uint32), b,
                                              h, t, t, DROPOUT))
    onp.testing.assert_array_equal(dense != 0, keep.numpy())


def _inputs(dtype, t, seed=3):
    b, h, d = 2, 2, 16
    rng = onp.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (b, h, t, d)).astype(onp.float32)).to(dtype) for _ in range(4))
    dlse = torch.from_numpy(rng.standard_normal((b, h, t)).astype(
        onp.float32))
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[0] = 0                       # a batch row with no valid key
    mask[1, t * 2 // 3:] = 0
    return q, k, v, dout, dlse, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mask", "causal", "mask_causal_dlse"])
def test_dead_pairs_leave_their_bits_unused(dtype, case):
    """Flipping the bits of every pair whose p is 0 (padding keys, a row
    with no valid key, causally hidden pairs, the padding past T) changes
    nothing in the plain B5, which equals the plain backward's dk, dv."""
    t = 45
    q, k, v, dout, dlse, mask = _inputs(dtype, t)
    kw = {"dropout": DROPOUT, "key": KEY}
    if "mask" in case:
        kw["mask"] = mask
    if "causal" in case:
        kw["causal"] = True
    dl = dlse if "dlse" in case else None
    out, lse = fa.flash_attention_reference(q, k, v, **kw)
    b, h = q.shape[:2]
    words = fa.keep_words_reference(KEY, b, h, t, DROPOUT,
                                    mask=kw.get("mask"),
                                    causal=kw.get("causal", False))
    live = fa._pack_bits(fa._live_pairs(b, t, kw.get("mask"),
                                        kw.get("causal", False), "cpu")
                         .expand(b, h, t, t))
    flipped = words ^ ~live
    assert not torch.equal(flipped, words)
    delta = fa._delta(out, dout, dl)
    plain = fa.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                  dlse=dl, **kw)
    dkv_kw = {n: kw[n] for n in ("mask", "causal") if n in kw}
    for w in (words, flipped):
        dk, dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, lse, dout, delta, w, dropout=DROPOUT, **dkv_kw)
        assert torch.equal(dk, plain[1]) and torch.equal(dv, plain[2])
    if "mask" in kw:
        assert bool((plain[1][0] == 0).all()) and bool((plain[2][0] == 0).all())


class _FakeBwdLib:
    """Stands in for the built library: records each call's arguments
    (checked against the declared argtypes) and returns CUDA's 0."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail
        self.flash_attention_bwd_dq = self._entry("dq")
        self.flash_attention_bwd_dkv = self._entry("dkv")

    def _entry(self, name):
        lib = self

        class Entry:
            argtypes = None
            restype = None

            def __call__(self, *args):
                assert len(args) == len(self.argtypes)
                lib.calls.append((name, args))
                return 719 if lib.fail else 0

        return Entry()


def _fake_launch(monkeypatch, fake):
    def load(name, declare):
        assert name == "flash_attention_bwd"
        declare(fake)
        return fake

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(fa, "stream_of", lambda x: 0x5150)


@pytest.mark.parametrize("dropout", [0.0, DROPOUT])
def test_wrapper_launches_b4_then_b5_with_its_buffers(monkeypatch, dropout):
    fake = _FakeBwdLib()
    _fake_launch(monkeypatch, fake)
    t = 45
    q, k, v, dout, dlse, mask = _inputs(torch.bfloat16, t)
    out, lse = fa.flash_attention_reference(q, k, v, mask=mask)
    args = fa._LaunchArgs(q, False, 0.25, mask, None, dropout, KEY)
    before = (fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches)
    dq, dk, dv = fa._launch_backward(q, k, v, out, lse, dout, dlse, args)
    assert (fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches) == \
        (before[0] + 1, before[1] + 1)
    assert [c[0] for c in fake.calls] == ["dq", "dkv"]
    (_, a4), (_, a5) = fake.calls
    # B4: q, k, v, dout, out, lse, dlse, delta, words, dq, stats; B5: q,
    # k, v, dout, lse, delta, words, dk, dv, stats; both end with the same
    # tail
    assert a4[:4] == a5[:4] == tuple(x.data_ptr() for x in (q, k, v, dout))
    assert a4[4] == out.data_ptr() and a4[5] == a5[4] == lse.data_ptr()
    assert a4[6] is not None                # dlse
    assert a5[5] == a4[7] is not None       # delta, written by B4
    assert a5[6] == a4[8] is not None       # the words, written by B4
    assert a4[9] == dq.data_ptr() and a4[10] is None and a5[9] is None
    assert (a5[7], a5[8]) == (dk.data_ptr(), dv.data_ptr())
    assert a4[11:] == a5[10:] == args.tail(0x5150, args.bwd_d)
    assert a4[-1] == 0x5150
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_wrapper_copies_a_misaligned_view(monkeypatch):
    """The kernels copy rows 16 bytes at a time: an operand that starts
    off a 16-byte boundary is copied, not handed over."""
    fake = _FakeBwdLib()
    _fake_launch(monkeypatch, fake)
    q, k, v, dout, _, _ = _inputs(torch.bfloat16, 32)
    flat = torch.zeros(dout.numel() + 1, dtype=dout.dtype)
    shifted = flat[1:].view(dout.shape)
    shifted.copy_(dout)
    assert shifted.data_ptr() % 16
    out, lse = fa.flash_attention_reference(q, k, v)
    args = fa._LaunchArgs(q, False, 0.25, None, None, 0.0, None)
    fa._launch_backward(q, k, v, out, lse, shifted, None, args)
    for _, a in fake.calls:
        assert a[3] % 16 == 0 and a[3] != shifted.data_ptr()


def test_wrapper_raises_on_what_the_kernels_do_not_take(monkeypatch):
    fake = _FakeBwdLib()
    _fake_launch(monkeypatch, fake)
    q, k, v, dout, _, _ = _inputs(torch.bfloat16, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa._LaunchArgs(torch.zeros(1, 1, 32, fa.FLASH_MAX_HEAD_DIM + 1,
                                   device="meta"), False, 1.0, None, None,
                       0.0, None)
    with pytest.raises(TypeError, match="float16"):
        fa._LaunchArgs(q.double(), False, 1.0, None, None, 0.0, None)
    out, lse = fa.flash_attention_reference(q, k, v)
    args = fa._LaunchArgs(q, False, 0.25, None, None, DROPOUT, KEY)
    with pytest.raises(ValueError, match="dout must be"):
        fa._launch_backward(q, k, v, out, lse, dout.float(), None, args)
    with pytest.raises(ValueError, match="contiguous"):
        fa._launch_backward(q, k, v, out, lse,
                            dout.transpose(2, 3).contiguous().transpose(2, 3),
                            None, args)
    with pytest.raises(ValueError, match="words B4 wrote"):
        fa._launch_dkv(q, k, v, dout, lse, torch.zeros(lse.shape), None,
                       args)
    assert fake.calls == []
    fake.fail = True
    with pytest.raises(RuntimeError, match="bwd_dq launch failed.*719"):
        fa._launch_backward(q, k, v, out, lse, dout, None, args)


def _c_params(name):
    src = (ROOT / "mxnet_tpu_torch" / "csrc" / "flash_attention_bwd.cu"
           ).read_text()
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("name", ["flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv"])
def test_ctypes_declarations_match_the_c_entry_points(name):
    """Each declared argument has the C parameter's kind: a pointer, a
    64-bit or 32-bit integer, or a float."""
    fake = _FakeBwdLib()
    fa._declare_bwd(fake)
    entry = getattr(fake, name)
    params = _c_params(name)
    assert len(params) == len(entry.argtypes)
    for param, ctype in zip(params, entry.argtypes):
        if "*" in param:
            assert ctype is ctypes.c_void_p, param
        elif param.startswith("long long"):
            assert ctype is ctypes.c_longlong, param
        elif param.startswith("unsigned int"):
            assert ctype is ctypes.c_uint, param
        elif param.startswith("int"):
            assert ctype is ctypes.c_int, param
        else:
            assert param.startswith("float") and ctype is ctypes.c_float, \
                param
