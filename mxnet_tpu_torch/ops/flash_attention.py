"""Flash attention, forward and backward: the port of kernels B3, B4, B5.

Counterpart of `mxnet_tpu/ops/pallas_kernels.py` (`flash_attention`,
`flash_attention_with_lse`, `_flash_backward`, `attn_dropout_mask`,
`_threefry2x32`, `_kend`).  The TPU kernel `_fwd_kernel` becomes the
hand-written CUDA kernel in `csrc/flash_attention_fwd.cu` (B3), and
`_bwd_dq_kernel` / `_bwd_dkv_kernel` become the two kernels of
`csrc/flash_attention_bwd.cu` (B4, B5); each source's header says what
bounds it and how it is built.  This module holds their wrappers and,
beside them, the plain PyTorch versions of the same functions,
`flash_attention_reference`, `flash_attention_backward_reference` (B4
and B5 together), and, for the contract between B4 and B5,
`keep_words_reference` and `flash_attention_bwd_dkv_reference`.

A tensor on the card launches the kernels, or the wrapper raises: there
is no fallback.  A tensor on the CPU takes the plain versions; that is
what the CPU tests run.  The wrappers count their launches in
``FLASH_FWD.launches``, ``FLASH_BWD_DQ.launches`` and
``FLASH_BWD_DKV.launches``.

Semantics, as in the reference: scores are ``q k^T * scale`` in f32,
then the bias is added, then the causal and key-padding masks fill
``-1e30``.  Rows with no valid key give exact zeros (and exact zero
gradients) and an lse below ``_MASKED_ROW``.  Dropout zeroes softmax
weights at rate ``dropout`` and rescales survivors by 1/keep, with bits
from a stateless threefry2x32 hash of (seed, batch*head, q_pos, k_pos),
which the backward draws again once: B4, launched first, writes them as
packed words with the row sums delta = rowsum(dO * out) - dlse, and B5
reads both.  The lse is that of the undropped softmax.  f32 stays true
f32; with bf16 or f16 inputs p is rounded to the input type before the
PV product, and in the backward ds and p*keep are rounded to it before
their products, which accumulate in f32.

The kernels take f32, bf16 and f16, any head_dim up to
`FLASH_MAX_HEAD_DIM` and any batch*heads (`flash_supported` says so, and
the model's ``"auto"`` policy asks it).  Up to 128, B3 takes a head_dim
that is a multiple of 8 as it is (16-bit types); the wrappers zero-pad D
for the rest, and for B4/B5 to the next of 16, 32, 64, 128: zero columns
add exact zeros to every product and sum, and the gradients are sliced
back.  Past 128 all three take D as it is, through chunked kernels that
sum the scores over D in chunks and give each block a chunk of the
output's columns (see the sources' headers); B4's delta there follows the
order of torch's CUDA row sum (`torch_row_sum` in the backward's source).

The dropout seed words reach the kernels through a pointer to two
uint32 words in device memory, never by value: a training step captured
as a CUDA graph (`gluon.FusedTrainStep`) rewrites those words before each
replay.  ``key`` may be that device tensor (int32, two words, on the
inputs' device, as `ops.seeds` hands it out) or host words, which the
wrapper copies to the device without a sync.

The gradient is a `torch.autograd.Function` around the three kernels:
q, k and v get gradients; the mask, the bias (a constant, as in the
reference's `_zero_cts`) and the seed words get none.  A cotangent on
the lse output of `flash_attention_with_lse` folds into delta.  The
kernels take any sequence length, as the reference does at its default
block sizes (a length with no power-of-two divisor runs there as one
block): the last K and Q tiles are masked inside the kernels.  The
reference's explicit ``block_q``/``block_k`` arguments, and the
ValueError they raise when they do not divide T, have no counterpart
here.  The model's ``use_flash="auto"`` policy keeps the reference's
shape contract (T <= 128 or a multiple of 128).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, stream_of
from .seeds import words_tensor
from .threefry import threefry2x32

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "flash_attention_backward_reference",
           "flash_attention_bwd_dkv_reference", "attn_dropout_mask",
           "keep_words_reference", "flash_supported", "FLASH_MAX_HEAD_DIM",
           "FLASH_FWD", "FLASH_BWD_DQ", "FLASH_BWD_DKV"]

_NEG_INF = -1e30
_MASKED_ROW = -1e29
_BH_FOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF
# the head dims B4/B5 (and B3 in f32) are built for; others up to 128 are
# padded, and past 128 the chunked kernels take D as it is
_HEAD_DIMS = (16, 32, 64, 128)
FLASH_MAX_HEAD_DIM = 32768
# batch*heads is folded over two grid dimensions and indexed in int32
_MAX_BATCH_HEADS = 2 ** 31 - 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TYPE_NAMES = {0: "float32", 1: "bfloat16", 2: "float16"}


def flash_supported(dtype, head_dim, batch_heads):
    """Whether the CUDA kernels take (B, H, T, head_dim) inputs of
    ``dtype`` with B * H = ``batch_heads``: f32, bf16 or f16, any head
    dim up to `FLASH_MAX_HEAD_DIM` (past 128 through the chunked kernels;
    up to there B4's delta follows torch's one-block row sum), any
    sequence length.  `_LaunchArgs` refuses the rest, and the model's
    ``"auto"`` policy never picks flash for them."""
    return (dtype in _DTYPES and 1 <= head_dim <= FLASH_MAX_HEAD_DIM and
            1 <= batch_heads <= _MAX_BATCH_HEADS)


FLASH_FWD = Kernel("flash_attention_fwd")
FLASH_BWD_DQ = Kernel("flash_attention_bwd_dq")
FLASH_BWD_DKV = Kernel("flash_attention_bwd_dkv")


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds), first output word, on int64 tensors
    holding uint32 values (broadcasting; `ops.threefry`); bit-identical
    to the reference's `_threefry2x32`.  The CUDA kernels use native
    uint32."""
    return threefry2x32(k0, k1, c0, c1)[0]


def _keep_threshold(keep):
    """uint32 threshold with P(bits < threshold) = keep."""
    return min(int(round(keep * 4294967296.0)), 4294967295)


def _seed_words(key):
    """Two uint32 seed words from ``key``: a sequence, array or tensor of
    integer words (one word is used twice), as the reference takes raw
    words."""
    words = [int(w) & _M32 for w in torch.as_tensor(key).reshape(-1).tolist()]
    if not words:
        raise ValueError("dropout key needs at least one uint32 word")
    return (words + words)[:2]


def attn_dropout_mask(key, b, h, t_q, t_k, dropout, device="cpu"):
    """The keep/rescale mask the kernel draws: (B, H, T_q, T_k) f32 of
    {0, 1/keep}.  Used by the plain version and by tests; never built on
    the kernel's path."""
    keep = 1.0 - float(dropout)
    s0, s1 = _seed_words(key)
    bh = torch.arange(b * h, dtype=torch.int64, device=device)
    k0 = (s0 ^ ((bh * _BH_FOLD) & _M32)).reshape(b * h, 1, 1)
    qp = torch.arange(t_q, dtype=torch.int64, device=device).reshape(1, t_q, 1)
    kp = torch.arange(t_k, dtype=torch.int64, device=device).reshape(1, 1, t_k)
    bits = _threefry2x32(k0, s1, qp, kp)
    inv_keep = torch.tensor(1.0 / keep, dtype=torch.float32)
    mask = torch.where(bits < _keep_threshold(keep), inv_keep.to(device),
                       torch.zeros((), dtype=torch.float32, device=device))
    return mask.reshape(b, h, t_q, t_k)


def _words(t):
    """Keep words per query row: ceil(t / 32)."""
    return (t + 31) // 32


def _pack_bits(bits):
    """bool (..., T_q, T_k) -> int32 words (..., T_q, ceil(T_k/32)), bit
    j of word w = bits[..., 32w + j] (the uint32 pattern held in int32)."""
    t_k = bits.shape[-1]
    padded = torch.zeros(*bits.shape[:-1], _words(t_k) * 32,
                         dtype=torch.int64, device=bits.device)
    padded[..., :t_k] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(*bits.shape[:-1], -1, 32) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _unpack_bits(words, t_k):
    """The inverse of `_pack_bits`: bool (..., T_q, T_k)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :t_k].bool()


def _live_pairs(b, t, mask, causal, device):
    """(B, 1, T, T) bool: the (query, key) pairs whose p can be nonzero,
    a valid key and, when causal, not after the query."""
    live = torch.ones(b, 1, t, t, dtype=torch.bool, device=device)
    if causal:
        live = live & torch.ones(t, t, dtype=torch.bool, device=device).tril()
    if mask is not None:
        live = live & _norm_mask(mask).bool().reshape(b, 1, 1, t)
    return live


def keep_words_reference(key, b, h, t, dropout, mask=None, causal=False,
                         device="cpu"):
    """The packed keep mask B4 writes and B5 reads (the first plane of
    B4's words): int32 words (B, H, T, ceil(T/32)), bit j of word w in
    row q = keep(q, 32w + j), the bits of
    `attn_dropout_mask`; 0 for pairs whose p is exactly 0 (a padding
    key, a causally hidden pair), which the kernels do not draw."""
    keep = attn_dropout_mask(key, b, h, t, t, dropout, device=device) != 0
    return _pack_bits(keep & _live_pairs(b, t, mask, causal, device))


# ---------------------------------------------------------------------------
# argument plumbing
# ---------------------------------------------------------------------------
def _norm_mask(mask):
    """Key-padding mask (B, T_k), any dtype -> int32 0/1."""
    if mask.ndim != 2:
        raise ValueError(
            f"flash_attention mask must be a (batch, key_len) key-padding "
            f"mask; got ndim={mask.ndim} (full (b, t, s) attention masks "
            "take the dense path)")
    return (mask != 0).to(torch.int32).contiguous()


def _kend(mi):
    """(B,) int32: 1 + index of the last valid key (0 when none).  K
    tiles at or past it are fully masked; the kernel skips them."""
    t = mi.shape[1]
    pos = torch.arange(1, t + 1, dtype=torch.int32, device=mi.device)
    return (mi * pos).amax(dim=1).to(torch.int32)


def _bias_4d(bias, b, h, t):
    """Normalize an additive attention bias to (B|1, H|1, T, T)."""
    if bias.ndim == 2:
        bias = bias.reshape(1, 1, *bias.shape)
    elif bias.ndim == 3:
        bias = bias.reshape(1, *bias.shape)
    bb, hb, tq, tk = bias.shape
    if tq != t or tk != t or bb not in (1, b) or hb not in (1, h):
        raise ValueError(
            f"bias shape {tuple(bias.shape)} must broadcast to "
            f"({b}, {h}, {t}, {t})")
    return bias


def _check(q, k, v, dropout):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention takes q, k, v of one shape "
                         f"(B, H, T, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("flash_attention takes q, k, v all float32, all "
                        "bfloat16 or all float16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not 0.0 <= float(dropout) < 1.0:
        raise ValueError(f"dropout must be in [0, 1); got {dropout}")




# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def _masked_scores(q, k, sc, causal, mask, bias):
    """(B, H, T, T) f32 scores: q k^T * scale, plus the bias, then the
    causal and key-padding fills."""
    b, h, t, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sc
    if bias is not None:
        s = s + _bias_4d(bias, b, h, t).float()
    if causal:
        tril = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tril, _NEG_INF)
    if mask is not None:
        valid = _norm_mask(mask).bool().reshape(b, 1, 1, t)
        s = s.masked_fill(~valid, _NEG_INF)
    return s


def _delta(out, dout, dlse):
    """(B, H, T) f32: rowsum(dO * out), minus the lse cotangent if any
    (d s picks up p * dlse, which ds = p (dp - delta) absorbs)."""
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def flash_attention_reference(q, k, v, causal=False, scale=None, mask=None,
                              bias=None, dropout=0.0, key=None):
    """Plain PyTorch version of the forward kernel's function, on whole
    rows: ``(out, lse)`` with out in q's dtype and lse (B, H, T) f32.
    Takes the same arguments as `flash_attention_with_lse`."""
    _check(q, k, v, dropout)
    b, h, t, d = q.shape
    sc = d ** -0.5 if scale is None else scale
    s = _masked_scores(q, k, sc, causal, mask, bias)
    m = s.amax(dim=-1, keepdim=True)
    # a row with no valid key: anchor the exponent at 0 so its p is 0
    m_exp = m if mask is None else torch.where(m > _MASKED_ROW, m,
                                               torch.zeros_like(m))
    p = torch.exp(s - m_exp)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout:
        if key is None:
            raise ValueError("dropout > 0 needs an explicit key")
        p = p * attn_dropout_mask(key, b, h, t, t, dropout, device=q.device)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, out, lse, dout, mask=None,
                                       bias=None, causal=False, scale=None,
                                       dropout=0.0, key=None, dlse=None):
    """Plain PyTorch version of the backward kernels' function, on whole
    rows: ``(dq, dk, dv)`` in the input dtype, from the forward's
    ``out`` and ``lse``, the output cotangent ``dout`` and, for
    `flash_attention_with_lse`, the lse cotangent ``dlse``.  It recomputes
    p from the saved lse and rounds ds and p*keep to the input dtype at
    the points where the kernels round them."""
    _check(q, k, v, dropout)
    b, h, t, d = q.shape
    sc = d ** -0.5 if scale is None else scale
    s = _masked_scores(q, k, sc, causal, mask, bias)
    lse = lse.float().unsqueeze(-1)
    if mask is not None:
        lse = torch.where(lse > _MASKED_ROW, lse, torch.zeros_like(lse))
    p = torch.exp(s - lse)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    pk = p
    if dropout:
        if key is None:
            raise ValueError("dropout > 0 needs an explicit key")
        keep = attn_dropout_mask(key, b, h, t, t, dropout, device=q.device)
        dp = dp * keep
        pk = p * keep
    ds = p * (dp - _delta(out, dout, dlse).unsqueeze(-1)) * sc
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(pk.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, lse, dout, delta, keep,
                                      mask=None, bias=None, causal=False,
                                      scale=None, dropout=0.0):
    """Plain PyTorch version of B5's function: ``(dk, dv)`` from the
    forward's lse and B4's delta (B, H, T) and keep words (`keep_words_
    reference`'s layout; None without dropout), rounded as the kernel
    rounds them."""
    _check(q, k, v, dropout)
    b, h, t, d = q.shape
    sc = d ** -0.5 if scale is None else scale
    s = _masked_scores(q, k, sc, causal, mask, bias)
    lse = lse.float().unsqueeze(-1)
    if mask is not None:
        lse = torch.where(lse > _MASKED_ROW, lse, torch.zeros_like(lse))
    p = torch.exp(s - lse)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    pk = p
    if dropout:
        inv_keep = torch.tensor(1.0 / (1.0 - dropout), dtype=torch.float32)
        ks = _unpack_bits(keep, t) * inv_keep.to(q.device)
        dp = dp * ks
        pk = p * ks
    ds = (p * (dp - delta.float().unsqueeze(-1)) * sc).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(pk.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _tail_types():
    """ctypes of the arguments every kernel's C entry ends with."""
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    ll = ctypes.c_longlong
    return [p, p, p, ll, ll, i, i, i, i, i, i, f, i, i, p, u, f, p]


def _declare_fwd(lib):
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + _tail_types()
    lib.flash_attention_fwd.restype = ctypes.c_int


def _declare_bwd(lib):
    p = ctypes.c_void_p
    tail = _tail_types()
    lib.flash_attention_bwd_dq.argtypes = [p] * 11 + tail
    lib.flash_attention_bwd_dq.restype = ctypes.c_int
    lib.flash_attention_bwd_dkv.argtypes = [p] * 10 + tail
    lib.flash_attention_bwd_dkv.restype = ctypes.c_int


def _ptr(x):
    return None if x is None else x.data_ptr()


def _seed_on(key, device):
    """The two seed words of ``key`` as an int32 (2,) tensor on
    ``device``: ``key`` itself when it already is one (a slot of a step's
    seed table), else the host words, copied without a sync."""
    if isinstance(key, torch.Tensor) and key.device == device and \
            key.dtype == torch.int32 and key.numel() == 2 and \
            key.is_contiguous():
        return key
    return words_tensor(_seed_words(key), device)


class _LaunchArgs:
    """What the three kernels take besides q, k, v: the int32 mask and
    its ``kend``, the f32 bias with its batch and head strides, the
    dropout seed words (on the device), threshold and rescale, the head
    dims the kernels run at (``fwd_d`` for B3, ``bwd_d`` for B4/B5; the
    true one when no padding is needed, always past 128).  Built once per
    forward and reused by its backward."""

    def __init__(self, q, causal, sc, mask, bias, dropout, key):
        b, h, t, d = q.shape
        if q.dtype not in _DTYPES:
            raise TypeError(f"the CUDA kernels take float32, bfloat16 or "
                            f"float16; got {q.dtype}")
        if not flash_supported(q.dtype, d, b * h):
            raise ValueError(
                f"the CUDA kernels take head_dim 1..{FLASH_MAX_HEAD_DIM} "
                f"and batch*heads up to {_MAX_BATCH_HEADS}; got head_dim "
                f"{d}, batch*heads {b * h}")
        self.dims = (b, h, t, d, _DTYPES[q.dtype])
        if d > _HEAD_DIMS[-1]:
            self.fwd_d = self.bwd_d = d
        else:
            self.bwd_d = next(n for n in _HEAD_DIMS if n >= d)
            self.fwd_d = self.bwd_d if q.dtype == torch.float32 else \
                -(-d // 8) * 8
        self.causal = int(bool(causal))
        self.scale = float(sc)
        self.mask = self.kend = None
        if mask is not None:
            if mask.device != q.device or tuple(mask.shape) != (b, t):
                raise ValueError(f"mask must be ({b}, {t}) on {q.device}")
            self.mask = _norm_mask(mask)
            self.kend = _kend(self.mask)
        self.bias = None
        self.bias_sb = self.bias_sh = 0
        if bias is not None:
            if bias.device != q.device:
                raise ValueError(f"bias must lie on {q.device}")
            self.bias = _bias_4d(bias, b, h, t).to(torch.float32).contiguous()
            bb, hb = self.bias.shape[0], self.bias.shape[1]
            self.bias_sb = hb * t * t if bb > 1 else 0
            self.bias_sh = t * t if hb > 1 else 0
        self.seed = None                # int32 (2,) on the device
        self.keep = (0, 1.0)            # threshold, 1/keep
        if dropout:
            if key is None:
                raise ValueError("dropout > 0 needs an explicit key")
            self.seed = _seed_on(key, q.device)
            self.keep = (_keep_threshold(1.0 - dropout),
                         1.0 / (1.0 - dropout))
        self.dropout = int(bool(dropout))

    def tail(self, stream, d_kernel):
        """The arguments every kernel's C entry ends with, for a launch
        on rows of ``d_kernel`` elements."""
        b, h, t, d, dt = self.dims
        thr, inv_keep = self.keep
        return (_ptr(self.mask), _ptr(self.kend), _ptr(self.bias),
                self.bias_sb, self.bias_sh, b, h, t, d_kernel, d, dt,
                self.scale, self.causal, self.dropout, _ptr(self.seed), thr,
                float(inv_keep), stream)


def _contiguous(**tensors):
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, H, T, D)")


def _operands(args, device, d_kernel, **tensors):
    """(B, H, T, D) operands as a kernel takes them: of the forward's
    shape and type on its device, contiguous, zero-padded along D to
    ``d_kernel``, and 16-byte aligned (the kernels copy rows 16 bytes at
    a time; a view that starts elsewhere is copied)."""
    b, h, t, d, dt = args.dims
    out = []
    for name, x in tensors.items():
        if tuple(x.shape) != (b, h, t, d) or _DTYPES.get(x.dtype) != dt or \
                x.device != device:
            raise ValueError(
                f"{name} must be ({b}, {h}, {t}, {d}) {_TYPE_NAMES[dt]} on "
                f"{device}; got {tuple(x.shape)} {x.dtype} on {x.device}")
        _contiguous(**{name: x})
        if d_kernel != d:
            x = torch.nn.functional.pad(x, (0, d_kernel - d))
        out.append(x if x.data_ptr() % 16 == 0 else x.clone())
    return out


def _unpad(x, d):
    """A kernel's (B, H, T, D) output back to head dim ``d``."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _launch_fwd(q, k, v, args):
    from . import _build

    b, h, t, d, _ = args.dims
    q, k, v = _operands(args, q.device, args.fwd_d, q=q, k=k, v=v)
    lib = _build.load("flash_attention_fwd", _declare_fwd)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = stream_of(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *args.tail(stream, args.fwd_d))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    FLASH_FWD.launches += 1
    return _unpad(out, d), lse


def _rows(x):
    """A (B, H, T) f32 operand, contiguous, or None."""
    return None if x is None else x.float().contiguous()


def _launch_dq(q, k, v, out, dout, lse, dlse, args, stats=None):
    """B4 on the current stream: ``(dq, delta, words)``, with delta =
    rowsum(dout * out) - dlse (B, H, T) f32, summed as torch sums it,
    and words (2, B, H, T, ceil(T/32)) int32: ``words[0]`` the dropout
    bits it drew, ``words[1]`` (bf16 / f16) the pairs whose rounding B4
    and B5 derive again; both for B5.  ``stats``, an int64 tensor of one
    element, counts the 16-bit elements whose rounding the kernel
    derived again."""
    from . import _build

    b, h, t, d, _ = args.dims
    q, k, v, out, dout = _operands(args, q.device, args.bwd_d, q=q, k=k,
                                   v=v, out=out, dout=dout)
    lse, dlse = _rows(lse), _rows(dlse)
    lib = _build.load("flash_attention_bwd", _declare_bwd)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    words = torch.empty((2, b, h, t, _words(t)), dtype=torch.int32,
                        device=q.device)
    stream = stream_of(q)
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _ptr(dlse), delta.data_ptr(),
        words.data_ptr(), dq.data_ptr(), _ptr(stats),
        *args.tail(stream, args.bwd_d))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {err}")
    FLASH_BWD_DQ.launches += 1
    return _unpad(dq, d), delta, words


def _launch_dkv(q, k, v, dout, lse, delta, words, args, stats=None):
    """B5 on the current stream: ``(dk, dv)`` from the saved lse and B4's
    delta and words.  The kernel writes every row (exact zeros where it
    skipped the work), so empty outputs are safe."""
    from . import _build

    d = args.dims[3]
    q, k, v, dout = _operands(args, q.device, args.bwd_d, q=q, k=k, v=v,
                              dout=dout)
    if delta is None or words is None:
        raise ValueError("B5 needs the delta and the words B4 wrote")
    lib = _build.load("flash_attention_bwd", _declare_bwd)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = stream_of(q)
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        _rows(lse).data_ptr(), delta.data_ptr(), words.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _ptr(stats),
        *args.tail(stream, args.bwd_d))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {err}")
    FLASH_BWD_DKV.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def _launch_backward(q, k, v, out, lse, dout, dlse, args):
    """B4, then B5 on B4's delta and words: ``(dq, dk, dv)``."""
    dq, delta, words = _launch_dq(q, k, v, out, dout, lse, dlse, args)
    dk, dv = _launch_dkv(q, k, v, dout, lse, delta, words, args)
    return dq, dk, dv


def _forward(q, k, v, causal, sc, mask, bias, dropout, key):
    """(out, lse, launch args): the kernel on the card, the plain version
    on the CPU (launch args None)."""
    if q.device.type == "cuda":
        args = _LaunchArgs(q, causal, sc, mask, bias, dropout, key)
        return (*_launch_fwd(q, k, v, args), args)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or the CPU; got "
                         f"{q.device}")
    out, lse = flash_attention_reference(q, k, v, causal=causal, scale=sc,
                                         mask=mask, bias=bias,
                                         dropout=dropout, key=key)
    return out, lse, None


class _FlashAttention(torch.autograd.Function):
    """B3 forward; B4 and B5 backward (their plain versions on the
    CPU).  Gradients flow to q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, causal, sc, dropout, key):
        out, lse, args = _forward(q, k, v, causal, sc, mask, bias, dropout,
                                  key)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)
        ctx.launch_args = args
        ctx.plain_args = (mask, bias, causal, sc, dropout, key)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        if ctx.launch_args is not None:
            dq, dk, dv = _launch_backward(q, k, v, out, lse,
                                          dout.contiguous(), dlse,
                                          ctx.launch_args)
        else:
            mask, bias, causal, sc, dropout, key = ctx.plain_args
            dq, dk, dv = flash_attention_backward_reference(
                q, k, v, out, lse, dout, mask=mask, bias=bias, causal=causal,
                scale=sc, dropout=dropout, key=key, dlse=dlse)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None, mask=None,
                             bias=None, dropout=0.0, key=None):
    """Flash attention returning ``(out, lse)``: q/k/v (B, H, T, D) ->
    out (B, H, T, D) in the input dtype and the per-query log-sum-exp
    (B, H, T) in f32, that of the undropped softmax.  Differentiable in
    q, k and v (and through both outputs) when autograd records.

    ``mask``: key-padding mask (B, T), truthy = valid key.  ``bias``:
    additive score bias broadcastable to (B, H, T, T) as (T, T),
    (H, T, T) or (B|1, H|1, T, T), a constant (no gradient).
    ``dropout``/``key``: attention dropout at rate ``dropout`` with the
    two uint32 seed words ``key``.
    """
    _check(q, k, v, dropout)
    drop = float(dropout or 0.0)
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, mask, bias, bool(causal), sc,
                                     drop, key)
    return _forward(q, k, v, causal, sc, mask, bias, drop, key)[:2]


def flash_attention(q, k, v, causal=False, scale=None, mask=None, bias=None,
                    dropout=0.0, key=None):
    """Blockwise (flash) attention: q/k/v (B, H, T, D) -> (B, H, T, D).
    Exact attention without the (T, T) score matrix in device memory, in
    the forward or the backward; arguments as in
    `flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    mask=mask, bias=bias, dropout=dropout,
                                    key=key)[0]
