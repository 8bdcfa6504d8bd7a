"""Flash attention, forward and backward: the port of kernels B3, B4, B5.

Counterpart of `mxnet_tpu/ops/pallas_kernels.py` (`flash_attention`,
`flash_attention_with_lse`, `_flash_backward`, `attn_dropout_mask`,
`_threefry2x32`, `_kend`).  The TPU kernel `_fwd_kernel` becomes the
hand-written CUDA kernel in `csrc/flash_attention_fwd.cu` (B3), and
`_bwd_dq_kernel` / `_bwd_dkv_kernel` become the two kernels of
`csrc/flash_attention_bwd.cu` (B4, B5); each source's header says what
bounds it and how it is built.  This module holds their wrappers and,
beside them, the plain PyTorch versions of the same functions,
`flash_attention_reference` and `flash_attention_backward_reference`.

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
which the backward regenerates; the lse is that of the undropped
softmax.  f32 stays true f32; with bf16 inputs p is rounded to bf16
before the PV product, and in the backward ds and p*keep are rounded to
bf16 before their products, which accumulate in f32.

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

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "flash_attention_backward_reference",
           "attn_dropout_mask", "FLASH_FWD", "FLASH_BWD_DQ", "FLASH_BWD_DKV"]

_NEG_INF = -1e30
_MASKED_ROW = -1e29
_BH_FOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


FLASH_FWD = Kernel("flash_attention_fwd")
FLASH_BWD_DQ = Kernel("flash_attention_bwd_dq")
FLASH_BWD_DKV = Kernel("flash_attention_bwd_dkv")


# ---------------------------------------------------------------------------
# threefry2x32 dropout bits, in int64 arithmetic masked to 32 bits (torch's
# uint32 coverage on the CPU is thin); the CUDA kernel uses native uint32
# ---------------------------------------------------------------------------
def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds), first output word, on int64 tensors
    holding uint32 values (broadcasting); bit-identical to the
    reference's `_threefry2x32`."""
    k0, k1, c0, c1 = (torch.as_tensor(a, dtype=torch.int64) & _M32
                      for a in (k0, k1, c0, c1))
    ks2 = 0x1BD11BDA ^ k0 ^ k1
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    inj = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for i, (a, b) in enumerate(inj):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + a) & _M32
        x1 = (x1 + b + (i + 1)) & _M32
    return x0


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
        raise TypeError("flash_attention takes q, k, v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
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


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _declare_fwd(lib):
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
        i, i, i, i, i, f, i, i, u, u, u, f, p]
    lib.flash_attention_fwd.restype = ctypes.c_int


def _declare_bwd(lib):
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    ll = ctypes.c_longlong
    tail = [p, p, p, ll, ll, i, i, i, i, i, f, i, i, u, u, u, f, p]
    lib.flash_attention_bwd_dq.argtypes = [p] * 7 + tail
    lib.flash_attention_bwd_dq.restype = ctypes.c_int
    lib.flash_attention_bwd_dkv.argtypes = [p] * 8 + tail
    lib.flash_attention_bwd_dkv.restype = ctypes.c_int


def _ptr(x):
    return None if x is None else x.data_ptr()


class _LaunchArgs:
    """What the three kernels take besides q, k, v: the int32 mask and
    its ``kend``, the f32 bias with its batch and head strides, and the
    dropout seed words, threshold and rescale.  Built once per forward
    and reused by its backward."""

    def __init__(self, q, causal, sc, mask, bias, dropout, key):
        b, h, t, d = q.shape
        if d not in _HEAD_DIMS:
            raise ValueError(f"the CUDA kernels take head_dim in "
                             f"{_HEAD_DIMS}; got {d}")
        if b * h > 65535:
            raise ValueError(f"batch*heads = {b * h} exceeds the grid's "
                             "65535")
        self.dims = (b, h, t, d, _DTYPES[q.dtype])
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
        self.seed = (0, 0, 0, 1.0)      # seed0, seed1, threshold, 1/keep
        if dropout:
            if key is None:
                raise ValueError("dropout > 0 needs an explicit key")
            s0, s1 = _seed_words(key)
            self.seed = (s0, s1, _keep_threshold(1.0 - dropout),
                         1.0 / (1.0 - dropout))
        self.dropout = int(bool(dropout))

    def tail(self, stream):
        """The arguments every kernel's C entry ends with."""
        b, h, t, d, dt = self.dims
        s0, s1, thr, inv_keep = self.seed
        return (_ptr(self.mask), _ptr(self.kend), _ptr(self.bias),
                self.bias_sb, self.bias_sh, b, h, t, d, dt, self.scale,
                self.causal, self.dropout, s0, s1, thr, float(inv_keep),
                stream)


def _contiguous(**tensors):
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, H, T, D)")


def _launch_fwd(q, k, v, args):
    from . import _build

    _contiguous(q=q, k=k, v=v)
    b, h, t, _, _ = args.dims
    lib = _build.load("flash_attention_fwd", _declare_fwd)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = stream_of(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *args.tail(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    FLASH_FWD.launches += 1
    return out, lse


def _bwd_head(q, k, v, dout, lse, delta):
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}; got {tuple(dout.shape)} {dout.dtype} "
                         f"on {dout.device}")
    _contiguous(q=q, k=k, v=v, dout=dout)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _launch_dq(q, k, v, dout, lse, delta, args):
    """B4 on the current stream: dq from the saved lse and delta."""
    from . import _build

    lib = _build.load("flash_attention_bwd", _declare_bwd)
    head = _bwd_head(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    stream = stream_of(q)
    err = lib.flash_attention_bwd_dq(*head, dq.data_ptr(), *args.tail(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {err}")
    FLASH_BWD_DQ.launches += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, args):
    """B5 on the current stream: (dk, dv).  The kernel writes every row
    (exact zeros where it skipped the work), so empty outputs are safe."""
    from . import _build

    lib = _build.load("flash_attention_bwd", _declare_bwd)
    head = _bwd_head(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = stream_of(q)
    err = lib.flash_attention_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(),
                                      *args.tail(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {err}")
    FLASH_BWD_DKV.launches += 1
    return dk, dv


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
            dout = dout.contiguous()
            delta = _delta(out, dout, dlse).contiguous()
            dq = _launch_dq(q, k, v, dout, lse, delta, ctx.launch_args)
            dk, dv = _launch_dkv(q, k, v, dout, lse, delta, ctx.launch_args)
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
