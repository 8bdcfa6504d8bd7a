"""NN operators (counterpart of `mxnet_tpu/ops/nn.py`, but for its
sparse, spatial and attention helpers).  Plain functions on
``torch.Tensor``; the large products and the convolutions go to
``torch.matmul`` / ``F.linear`` / ``F.conv*d``, as the reference left
them to XLA.  Convolution, deconvolution and pooling take every layout
the reference takes; a channels-last input is handed to torch as a
permuted (channels-last) view, without a copy.

BatchNorm in train mode is the reference's own formulation, spelled in
torch ops (`batch_norm_train`), with its backward's per-channel
reduction as the hand-written CUDA kernel B1 (`bn_bwd_reduce`, source
`csrc/bn_bwd_reduce.cu`, replacing the TPU kernel `_bn_reduce_kernel`),
in two forms: the (N0, C, N1) form for channels-first activations and
the channel-minor form for N1 < `BN_ROWS_BELOW` (NHWC activations).
A tensor on the card launches the kernel or the wrapper raises; a
tensor on the CPU takes its plain version, `bn_bwd_reduce_reference`.
The wrapper counts its launches in ``BN_BWD_REDUCE.launches`` and
``BN_BWD_REDUCE_ROWS.launches``.

Dropout in train mode is two hand-written CUDA kernels (`dropout`,
source `csrc/dropout.cu`; not the port of a TPU kernel: the reference
draws its mask from XLA's random bits, which no mask of the port
matches).  The forward hashes one threefry2x32 of the draw's two seed
words for each pair of elements, pair j's counter (j mod 2^32, j div
2^32): its first word keeps element 2j, its second element 2j + 1 (an
odd count's last element takes the first), where the word is below the
keep threshold.  It reads the seed words from device memory, so a
captured training step draws fresh bits at every replay, and writes the
mask packed, one bit an element in int32 words (`pack_keep_bits`); the
backward kernel applies that mask to the output gradient and hashes
nothing.  Their plain versions, `dropout_forward_reference` (with
`dropout_reference`, its output alone) and `dropout_backward_reference`,
hash the same counters with the int64 threefry of `ops/threefry.py`.
``DROPOUT.launches`` counts the launches of both kernels,
``DROPOUT_BWD.launches`` those of the backward.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel, stream_of
from .flash_attention import _DTYPES, _M32, _keep_threshold, _seed_words
from .threefry import threefry2x32

__all__ = ["layer_norm", "fully_connected", "softmax", "log_softmax",
           "activation", "leaky_relu", "group_norm", "instance_norm",
           "dropout", "embedding", "pick", "convolution", "deconvolution",
           "pooling", "batch_norm_train",
           "batch_norm_inference", "bn_bwd_reduce", "bn_bwd_reduce_reference",
           "bn_bwd_reduce_plan", "bn_bwd_reduce_rows_plan", "BN_BWD_REDUCE",
           "BN_BWD_REDUCE_ROWS", "BN_ROWS_BELOW", "dropout_keep",
           "pack_keep_bits", "unpack_keep_bits", "dropout_reference",
           "dropout_forward_reference", "dropout_backward_reference",
           "DROPOUT", "DROPOUT_BWD"]

BN_BWD_REDUCE = Kernel("bn_bwd_reduce")
BN_BWD_REDUCE_ROWS = Kernel("bn_bwd_reduce_rows")
DROPOUT = Kernel("dropout")
DROPOUT_BWD = Kernel("dropout_bwd")


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis``, statistics from a single pass
    over the data, as the reference's.  PyTorch's fused kernel takes that
    pass (mean and variance by Welford's update, in f32 for bf16 data,
    where the reference sums x and x*x in one read) and applies gamma
    and beta in the same launch, rounding once to the input dtype: the
    same function to f32 rounding, in one kernel launch where the
    reference's formula spelled in torch ops takes 19 (PERF.md)."""
    ax = axis if axis >= 0 else data.ndim + axis
    x = data if ax == data.ndim - 1 else data.movedim(ax, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma.to(data.dtype),
                       beta.to(data.dtype), eps)
    return out if ax == data.ndim - 1 else out.movedim(-1, ax)


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias`` with the weight stored (out, in)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


def softmax(data, axis=-1):
    return torch.softmax(data, dim=axis)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "log_sigmoid": F.logsigmoid, "tanh": torch.tanh,
                "softrelu": F.softplus, "softsign": F.softsign,
                "mish": lambda x: x * torch.tanh(F.softplus(x))}


def activation(data, act_type="relu"):
    return _ACTIVATIONS[act_type](data)


# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """The reference's leaky_relu family, in its own formulas: ``leaky``
    (``slope`` below 0), ``prelu`` (``gamma`` per channel on axis 1),
    ``elu`` (``slope * (exp(x) - 1)``), ``selu``, ``gelu`` /
    ``gelu_tanh``, and ``rrelu`` at inference (the mean slope)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 and data.ndim > 2 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * (torch.exp(data) - 1))
    if act_type == "selu":
        neg = _SELU_ALPHA * torch.expm1(torch.where(data > 0, 0.0, data))
        return _SELU_SCALE * torch.where(data > 0, data, neg)
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "gelu_tanh":
        return F.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        return torch.where(data >= 0, data,
                           (lower_bound + upper_bound) / 2 * data)
    raise ValueError(f"unknown act_type {act_type!r}")


def group_norm(data, gamma, beta, num_groups, eps=1e-5):
    """Normalize each (sample, group of channels) of channels-first data
    by its mean and biased variance (two passes, as the reference), then
    gamma and beta per channel."""
    n, c = data.shape[0], data.shape[1]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    x = (x - mean) * torch.rsqrt(var.float() + eps).to(data.dtype)
    shape = (1, c) + (1,) * (data.ndim - 2)
    return x.reshape(data.shape) * gamma.reshape(shape) + beta.reshape(shape)


def instance_norm(data, gamma, beta, eps=1e-5):
    """Normalize each (sample, channel) of channels-first data over its
    spatial axes, then gamma and beta per channel."""
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, unbiased=False, keepdim=True)
    x = (data - mean) * torch.rsqrt(var.float() + eps).to(data.dtype)
    shape = (1, data.shape[1]) + (1,) * (data.ndim - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


def dropout_keep(n, seed, p, device="cpu"):
    """The keep mask of ``n`` elements in flat order, bool (n,): pair j
    hashes threefry2x32(seed words, (j mod 2^32, j div 2^32)); its first
    word keeps element 2j and its second element 2j + 1 where the word
    is below the threshold of keep 1 - ``p`` (an odd ``n``'s last element
    takes the first word).  ``seed``: two uint32 words (a tensor or a
    sequence)."""
    s0, s1 = _seed_words(seed)
    j = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(s0, s1, j & _M32, j >> 32)
    thr = _keep_threshold(1.0 - p)
    return torch.stack([w0 < thr, w1 < thr], dim=1).reshape(-1)[:n]


def pack_keep_bits(keep):
    """A flat bool mask packed as the forward kernel writes it: int32
    words holding uint32 bits, bit b of word w for element 32 w + b, the
    bits past the mask's end 0."""
    n = keep.numel()
    padded = torch.zeros(-(-n // 32) * 32, dtype=torch.int64,
                         device=keep.device)
    padded[:n] = keep.reshape(-1).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    words = (padded.reshape(-1, 32) << shifts).sum(dim=1)
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


def unpack_keep_bits(words, n):
    """The inverse of `pack_keep_bits`: bool (n,)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(-1)[:n].bool()


def _masked(data, keep, p):
    return torch.where(keep.reshape(data.shape), data * (1.0 / (1.0 - p)),
                       torch.zeros((), dtype=data.dtype, device=data.device))


def dropout_forward_reference(data, seed, p):
    """Plain version of the forward kernel: ``data`` with the elements
    `dropout_keep` keeps (in flat order) scaled by 1/(1 - p) in
    ``data``'s dtype and the rest zeros, and the mask packed
    (`pack_keep_bits`)."""
    keep = dropout_keep(data.numel(), seed, p, data.device)
    return _masked(data, keep, p), pack_keep_bits(keep)


def dropout_reference(data, seed, p):
    """The forward kernel's output, plain (`dropout_forward_reference`)."""
    return dropout_forward_reference(data, seed, p)[0]


def dropout_backward_reference(grad, bits, p):
    """Plain version of the backward kernel: ``grad`` with the elements
    the packed mask ``bits`` keeps scaled by 1/(1 - p), the rest zeros."""
    return _masked(grad, unpack_keep_bits(bits, grad.numel()), p)


def _declare_dropout(lib):
    p = ctypes.c_void_p
    lib.dropout_forward.argtypes = [p, p, p, p, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_uint,
                                    ctypes.c_float, p]
    lib.dropout_forward.restype = ctypes.c_int
    lib.dropout_backward.argtypes = [p, p, p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_float, p]
    lib.dropout_backward.restype = ctypes.c_int


def _empty_at_offset_of(x):
    """An empty tensor like the contiguous ``x`` whose data starts as far
    from a 16-byte boundary as ``x``'s (the kernels' 16-byte accesses
    then line up in both)."""
    lead = x.data_ptr() % 16 // x.element_size()
    if lead == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + lead, dtype=x.dtype, device=x.device)
    return buf[lead:].view(x.shape)


def _on_card(x):
    """Whether ``x`` takes the kernels (CUDA) or their plain versions
    (the CPU); other devices raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"dropout runs on CUDA or the CPU; got {x.device}")
    return True


def _kernel_input(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"the dropout kernel takes float32, bfloat16 or "
                        f"float16; got {x.dtype}")
    return x.contiguous()


def _dropout_forward(x, seed, p):
    """The forward kernel on a CUDA tensor, its plain version on a CPU
    one: the output and the packed keep bits."""
    if not _on_card(x):
        return dropout_forward_reference(x, seed, p)
    return _launch_forward(x, seed, p)


def _launch_forward(x, seed, p):
    x = _kernel_input(x)
    if seed.device != x.device or seed.dtype != torch.int32 or \
            seed.numel() != 2:
        raise ValueError(f"dropout's seed must be two int32 words on "
                         f"{x.device}")
    from . import _build

    n = x.numel()
    out = _empty_at_offset_of(x)
    bits = torch.empty(-(-n // 32), dtype=torch.int32, device=x.device)
    if n == 0:
        return out, bits
    lib = _build.load("dropout", _declare_dropout)
    err = lib.dropout_forward(x.data_ptr(), out.data_ptr(), bits.data_ptr(),
                              seed.contiguous().data_ptr(), n,
                              _DTYPES[x.dtype], _keep_threshold(1.0 - p),
                              1.0 / (1.0 - p), stream_of(x))
    if err != 0:
        raise RuntimeError(f"dropout forward launch failed: CUDA error {err}")
    DROPOUT.launches += 1
    return out, bits


def _dropout_backward(grad, bits, p):
    """The backward kernel on a CUDA tensor, its plain version on a CPU
    one: ``grad`` masked by the packed keep bits and rescaled."""
    if not _on_card(grad):
        return dropout_backward_reference(grad, bits, p)
    return _launch_backward(grad, bits, p)


def _launch_backward(grad, bits, p):
    grad = _kernel_input(grad)
    n = grad.numel()
    if bits.device != grad.device or bits.dtype != torch.int32 or \
            bits.numel() != -(-n // 32):
        raise ValueError(f"dropout's keep bits must be {-(-n // 32)} int32 "
                         f"words on {grad.device}")
    from . import _build

    dx = _empty_at_offset_of(grad)
    if n == 0:
        return dx
    lib = _build.load("dropout", _declare_dropout)
    err = lib.dropout_backward(grad.data_ptr(), bits.contiguous().data_ptr(),
                               dx.data_ptr(), n, _DTYPES[grad.dtype],
                               1.0 / (1.0 - p), stream_of(grad))
    if err != 0:
        raise RuntimeError(f"dropout backward launch failed: CUDA error "
                           f"{err}")
    DROPOUT.launches += 1
    DROPOUT_BWD.launches += 1
    return dx


class _Dropout(torch.autograd.Function):
    """The forward kernel, which saves the packed keep bits; the backward
    kernel applies them to the output gradient."""

    @staticmethod
    def forward(ctx, data, seed, p):
        out, bits = _dropout_forward(data, seed, p)
        ctx.save_for_backward(bits)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, grad):
        (bits,) = ctx.saved_tensors
        return _dropout_backward(grad, bits, ctx.p), None, None


def dropout(data, seed, p=0.5):
    """Zero elements at rate ``p`` and rescale the rest by 1/(1-p), with
    the keep mask hashed on the data's own device from the two seed words
    ``seed`` (an int32 (2,) tensor on that device, as `ops.seeds` hands
    them out): the kernels on the card, their plain versions on the CPU.
    No host-device copy, no sync."""
    if p == 0.0:
        return data
    return _Dropout.apply(data, seed, float(p))


class _Embedding(torch.autograd.Function):
    """Row lookup whose backward sums in a fixed order: the rows of the
    output gradient are accumulated into the weight's gradient by
    ``index_put_(accumulate=True)``, which on the card sorts the indices
    (stably) and adds each index's rows one after another, so two
    backwards of the same inputs agree bitwise.  torch's own embedding
    backward adds repeated indices with atomics on the card, in a varying
    order."""

    @staticmethod
    def forward(ctx, index, weight):
        ctx.save_for_backward(index)
        ctx.rows = weight.shape[0]
        return F.embedding(index, weight)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        width = grad.shape[-1]
        dw = torch.zeros((ctx.rows, width), dtype=grad.dtype,
                         device=grad.device)
        dw.index_put_((index.reshape(-1),), grad.reshape(-1, width),
                      accumulate=True)
        return None, dw


def embedding(data, weight):
    """``weight[data]``; the weight's gradient is summed in a fixed order
    (`_Embedding`).  A negative index counts from the end, as the
    reference's ``take`` reads it (a padding id of -1 is the last row)."""
    index = data.long()
    index = torch.where(index < 0, index + weight.shape[0], index)
    return _Embedding.apply(index, weight)


def pick(data, index, axis=-1):
    """``data`` at ``index`` along ``axis`` (which drops); out-of-range
    indices are clipped, as the reference's default ``mode="clip"``."""
    ax = axis if axis >= 0 else data.ndim + axis
    idx = index.long().clamp(0, data.shape[ax] - 1)
    return torch.gather(data, ax, idx.unsqueeze(ax)).squeeze(ax)


# ---------------------------------------------------------------------------
# convolution and pooling (NCW/NWC, NCHW/NHWC, NCDHW/NDHWC)
# ---------------------------------------------------------------------------
def _tuplize(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t * n if len(t) == 1 else t


_LAYOUTS = ("NCW", "NWC", "NCHW", "NHWC", "NCDHW", "NDHWC")


def _to_channels_first(data, layout):
    """(data as a channels-first view, the permutation back): the
    reference's layouts NCW/NCHW/NCDHW pass through; NWC/NHWC/NDHWC are
    permuted without a copy, so a contiguous NHWC tensor is handed to
    torch as a channels-last NCHW one, which cuDNN reads in place."""
    if layout not in _LAYOUTS or len(layout) != data.ndim:
        raise ValueError(f"layout {layout!r} for a {data.ndim}-d input: "
                         f"the reference's layouts are {_LAYOUTS}")
    if layout[1] == "C":
        return data, None
    nd = data.ndim
    return data.permute(0, nd - 1, *range(1, nd - 1)), \
        (0, *range(2, nd), 1)


def _back(out, perm):
    return out if perm is None else out.permute(*perm)


def convolution(data, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, layout="NCHW"):
    """N-d convolution in any of the reference's layouts, weight
    (num_filter, C // group, *kernel) in all of them, the result in the
    data's layout and dtype plus the bias."""
    x, perm = _to_channels_first(data, layout)
    nsp = data.ndim - 2
    conv = (F.conv1d, F.conv2d, F.conv3d)[nsp - 1]
    out = conv(x, weight, None, _tuplize(stride, nsp),
               _tuplize(pad if pad is not None else 0, nsp),
               _tuplize(dilate, nsp), num_group)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return _back(out, perm)


def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, layout="NCHW"):
    """Transposed convolution, weight (C_in, num_filter // group,
    *kernel) as the reference stores it: output size (in - 1) * stride
    - 2 * pad + dilate * (kernel - 1) + 1 + adj along each axis."""
    x, perm = _to_channels_first(data, layout)
    nsp = data.ndim - 2
    conv_t = (F.conv_transpose1d, F.conv_transpose2d,
              F.conv_transpose3d)[nsp - 1]
    out = conv_t(x, weight, None, _tuplize(stride, nsp),
                 _tuplize(pad if pad is not None else 0, nsp),
                 _tuplize(adj if adj is not None else 0, nsp), num_group,
                 _tuplize(dilate, nsp))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return _back(out, perm)


_POOLS = {"max": (F.max_pool1d, F.max_pool2d, F.max_pool3d),
          "avg": (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)}


def pooling(data, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, count_include_pad=True, layout="NCHW",
            pooling_convention="valid"):
    """Max, average or sum pooling.  ``pooling_convention='full'`` keeps
    the last partial window (ceil mode) by widening the high-side pad, as
    the reference does; an average's ``count_include_pad`` counts the
    user's padding but never that widening.  Any of the reference's
    layouts; the result is in the data's."""
    x, perm = _to_channels_first(data, layout)
    return _back(_pool_channels_first(x, kernel, pool_type, stride, pad,
                                      global_pool, count_include_pad,
                                      pooling_convention), perm)


def _pool_channels_first(data, kernel, pool_type, stride, pad, global_pool,
                         count_include_pad, pooling_convention):
    nsp = data.ndim - 2
    sp = tuple(range(2, data.ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=sp, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=sp, keepdim=True)
        return data.mean(dim=sp, keepdim=True)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    kernel = _tuplize(kernel, nsp)
    stride = _tuplize(stride if stride is not None else kernel, nsp)
    pad = _tuplize(pad if pad is not None else 0, nsp)
    his = []
    for size, k, s, p in zip(data.shape[2:], kernel, stride, pad):
        hi = p
        if pooling_convention == "full":
            out_ceil = -(-(size + 2 * p - k) // s) + 1
            hi = max(p, (out_ceil - 1) * s + k - size - p)
        his.append(hi)
    window = 1
    for k in kernel:
        window *= k
    simple = (list(his) == list(pad) and
              all(2 * p <= k for p, k in zip(pad, kernel)))
    if simple and pool_type == "max":
        return _POOLS["max"][nsp - 1](data, kernel, stride, pad)
    if simple and pool_type == "avg":
        return _POOLS["avg"][nsp - 1](data, kernel, stride, pad,
                                      count_include_pad=count_include_pad)
    # the general case: explicit (lo, hi) padding, then unpadded windows
    widths = [w for lo, hi in zip(reversed(pad), reversed(his))
              for w in (lo, hi)]
    if pool_type == "max":
        fill = float("-inf") if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        return _POOLS["max"][nsp - 1](F.pad(data, widths, value=fill),
                                      kernel, stride)
    summed = _POOLS["avg"][nsp - 1](F.pad(data, widths), kernel, stride) \
        * window
    if pool_type == "sum":
        return summed
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    if count_include_pad:
        base = [w for p in reversed(pad) for w in (p, p)]
        ones = F.pad(ones, base, value=1.0)
        extra = [w for p, hi in zip(reversed(pad), reversed(his))
                 for w in (0, hi - p)]
        ones = F.pad(ones, extra)
    else:
        ones = F.pad(ones, widths)
    counts = _POOLS["avg"][nsp - 1](ones, kernel, stride) * window
    return summed / counts


# ---------------------------------------------------------------------------
# BatchNorm (reference `_bn_train_fwd` / `_bn_train_bwd`)
# ---------------------------------------------------------------------------
def _bn_view(data, axis):
    """(N0, C, N1): the data as a channel-middle 3-d view (rows before
    the channel axis, the channel, elements after it)."""
    c = data.shape[axis]
    n0 = 1
    for s in data.shape[:axis]:
        n0 *= s
    return n0, c, data.numel() // (n0 * c)


def _bn_shape(data, axis):
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    return shape


def bn_bwd_reduce_reference(dy, xhat):
    """Plain version of B1: per-channel ``(sum(dy), sum(dy * xhat))`` of
    two (N0, C, N1) tensors, in their dtype (f32 on the path)."""
    return dy.sum(dim=(0, 2)), (dy * xhat).sum(dim=(0, 2))


_BN_THREADS = 256           # threads per block of the partial kernel
_BN_TARGET_BLOCKS = 4 * 132  # about four blocks per SM of an H100


def bn_bwd_reduce_plan(n0, c, n1):
    """(splits, chunk): the B1 kernel cuts each channel's M = N0 * N1
    elements into ``splits`` ranges of ``chunk`` (the last shorter), one
    block each, so that the card holds some four blocks per SM and every
    thread sums at least 8 elements."""
    m = n0 * n1
    splits = max(1, min(-(-_BN_TARGET_BLOCKS // c),
                        -(-m // (8 * _BN_THREADS))))
    chunk = -(-m // splits)
    return -(-m // chunk), chunk


# B1 reads the channel-minor form when fewer than this many elements
# follow the channel axis (N1 = 1: NHWC activations, BatchNorm of 2-d
# input); at and above it the (N0, C, N1) form.  On the H100 at 100M
# elements and C = 256 the channel-minor form was the faster at N1 = 16
# and the slower at N1 = 32 (chip_smoke.py's `kernel_bn_route` sweep,
# PERF.md)
BN_ROWS_BELOW = 32
_BN_ROWS_MAX_TW = 64        # column threads per row in the rows form


def bn_bwd_reduce_rows_plan(n0, c, n1, aligned=True):
    """(vec, tw, splits, chunk) of B1's channel-minor form on N0 rows of
    W = C * N1 floats: ``vec`` floats per load (4 when W % 4 == 0 and
    ``aligned``, else 1), ``tw`` column threads per row (a power of two,
    at most 64, no wider than W needs), so a block covers ``tw * vec``
    columns and 256 / ``tw`` rows at a time; the rows cut into ``splits``
    ranges of ``chunk`` (the last shorter), so that the card holds some
    four blocks per SM and every thread sums at least 32 rows (fewer
    partials for the final sum, which adds a channel's in one thread:
    on an H100 at ResNet-50's (25088, 256, 1), 8 rows a thread gave 523
    of them and 0.0551 ms of device time against the (N0, C, N1) form's
    0.0255 at (128, 256, 196); PERF.md)."""
    w = c * n1
    vec = 4 if aligned and w % 4 == 0 else 1
    tw = 1
    while tw < _BN_ROWS_MAX_TW and tw * vec < w:
        tw *= 2
    rows_per_pass = _BN_THREADS // tw
    tiles = -(-w // (tw * vec))
    splits = max(1, min(-(-_BN_TARGET_BLOCKS // tiles),
                        -(-n0 // (32 * rows_per_pass))))
    chunk = -(-n0 // splits)
    return vec, tw, -(-n0 // chunk), chunk


def _declare_bn(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_bwd_reduce.argtypes = [p, p, p, p, p, i, i, ll, i, ll, p]
    lib.bn_bwd_reduce.restype = ctypes.c_int
    lib.bn_bwd_reduce_rows.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, ll,
                                       p]
    lib.bn_bwd_reduce_rows.restype = ctypes.c_int


def bn_bwd_reduce(dy, xhat):
    """B1: per-channel ``(sum(dy), sum(dy * xhat))`` in f32 of two
    contiguous (N0, C, N1) f32 tensors.  On the card the CUDA kernel in
    its channel-minor form when N1 < `BN_ROWS_BELOW`, else in its
    (N0, C, N1) form (fixed summation order: two launches on the same
    inputs agree bitwise); on the CPU the plain version."""
    if dy.shape != xhat.shape or dy.ndim != 3 or dy.device != xhat.device:
        raise ValueError(f"bn_bwd_reduce takes two (N0, C, N1) tensors on one "
                         f"device; got {tuple(dy.shape)} on {dy.device} and "
                         f"{tuple(xhat.shape)} on {xhat.device}")
    if dy.device.type == "cpu":
        return bn_bwd_reduce_reference(dy, xhat)
    if dy.device.type != "cuda":
        raise ValueError(f"bn_bwd_reduce: unsupported device {dy.device}")
    if dy.dtype != torch.float32 or xhat.dtype != torch.float32:
        raise TypeError(f"the B1 kernel takes float32; got {dy.dtype}, "
                        f"{xhat.dtype}")
    if not (dy.is_contiguous() and xhat.is_contiguous()):
        raise ValueError("the B1 kernel takes contiguous (N0, C, N1) tensors")
    if dy.shape[2] < BN_ROWS_BELOW:
        return _bn_reduce_rows(dy, xhat)
    return _bn_reduce_channels(dy, xhat)


def _bn_reduce_channels(dy, xhat):
    """B1's (N0, C, N1) form on checked inputs."""
    from . import _build

    n0, c, n1 = dy.shape
    if c > 65535:
        raise ValueError(f"{c} channels exceed the grid's 65535")
    splits, chunk = bn_bwd_reduce_plan(n0, c, n1)
    lib = _build.load("bn_bwd_reduce", _declare_bn)
    part = torch.empty((2, c, splits), dtype=torch.float32, device=dy.device)
    out = torch.empty((2, c), dtype=torch.float32, device=dy.device)
    err = lib.bn_bwd_reduce(dy.data_ptr(), xhat.data_ptr(), part.data_ptr(),
                            out[0].data_ptr(), out[1].data_ptr(), n0, c, n1,
                            splits, chunk, stream_of(dy))
    if err != 0:
        raise RuntimeError(f"bn_bwd_reduce launch failed: CUDA error {err}")
    BN_BWD_REDUCE.launches += 1
    return out[0], out[1]


def _bn_reduce_rows(dy, xhat):
    """B1's channel-minor form on checked inputs."""
    from . import _build

    n0, c, n1 = dy.shape
    aligned = dy.data_ptr() % 16 == 0 and xhat.data_ptr() % 16 == 0
    vec, tw, splits, chunk = bn_bwd_reduce_rows_plan(n0, c, n1, aligned)
    lib = _build.load("bn_bwd_reduce", _declare_bn)
    part = torch.empty((2, c * n1, splits), dtype=torch.float32,
                       device=dy.device)
    out = torch.empty((2, c), dtype=torch.float32, device=dy.device)
    err = lib.bn_bwd_reduce_rows(dy.data_ptr(), xhat.data_ptr(),
                                 part.data_ptr(), out[0].data_ptr(),
                                 out[1].data_ptr(), n0, c, n1, vec, tw,
                                 splits, chunk, stream_of(dy))
    if err != 0:
        raise RuntimeError(f"bn_bwd_reduce_rows launch failed: CUDA error "
                           f"{err}")
    BN_BWD_REDUCE_ROWS.launches += 1
    return out[0], out[1]


def _promoted(dtype):
    """The statistics' dtype: f32 for bf16/f16/f32 data, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


class _BatchNormTrain(torch.autograd.Function):
    """Single-pass statistics (sum and sum of squares in f32, var =
    max(s2/n - mean^2, 0)), the scale and shift folded into one
    multiply-add, and the reference's hand-written backward: x-hat
    rebuilt in f32, one joint reduction (B1), one elementwise pass.
    dgamma and dbeta come back in gamma's dtype, dx in the data's.  The
    new running statistics are outputs without a gradient, computed in
    the running statistics' own dtype."""

    @staticmethod
    def forward(ctx, data, gamma, beta, moving_mean, moving_var, momentum,
                eps, axis):
        red = tuple(i for i in range(data.ndim) if i != axis)
        n = data.numel() // data.shape[axis]
        shape = _bn_shape(data, axis)
        cdt = _promoted(data.dtype)
        xf = data.to(cdt)
        s1 = xf.sum(dim=red)
        s2 = (xf * xf).sum(dim=red)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        a = gamma.to(cdt) * inv
        b = beta.to(cdt) - mean * a
        out = torch.addcmul(b.reshape(shape), xf, a.reshape(shape)).to(
            data.dtype)
        new_mean = moving_mean * momentum + \
            mean.to(moving_mean.dtype) * (1 - momentum)
        new_var = moving_var * momentum + \
            var.to(moving_var.dtype) * (1 - momentum)
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.axis = axis
        ctx.mark_non_differentiable(new_mean, new_var)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        data, gamma, mean, inv = ctx.saved_tensors
        axis = ctx.axis
        n0, c, n1 = _bn_view(data, axis)
        n = n0 * n1
        shape = _bn_shape(data, axis)
        cdt = _promoted(data.dtype)
        dyf = dy.to(cdt).contiguous()
        xhat = (data.to(cdt) - mean.reshape(shape)) * inv.reshape(shape)
        xhat = xhat.contiguous()
        if cdt == torch.float32:
            sum_dy, sum_dy_xhat = bn_bwd_reduce(dyf.view(n0, c, n1),
                                                xhat.view(n0, c, n1))
        else:
            sum_dy, sum_dy_xhat = bn_bwd_reduce_reference(
                dyf.view(n0, c, n1), xhat.view(n0, c, n1))
        a = (gamma.to(cdt) * inv).reshape(shape)
        dx = a * torch.addcmul(dyf - (sum_dy / n).reshape(shape), xhat,
                               (sum_dy_xhat / -n).reshape(shape))
        return (dx.to(data.dtype), sum_dy_xhat.to(gamma.dtype),
                sum_dy.to(gamma.dtype), None, None, None, None, None)


def batch_norm_train(data, gamma, beta, momentum, eps, axis, moving_mean,
                     moving_var):
    """Returns ``(out, new_moving_mean, new_moving_var)``; gradients
    reach data, gamma and beta (the running statistics get none)."""
    return _BatchNormTrain.apply(data, gamma, beta, moving_mean, moving_var,
                                 momentum, eps, axis % data.ndim)


def batch_norm_inference(data, gamma, beta, moving_mean, moving_var, eps,
                         axis):
    shape = _bn_shape(data, axis % data.ndim)
    inv = torch.rsqrt(moving_var.float() + eps).to(data.dtype)
    return (data - moving_mean.reshape(shape)) * inv.reshape(shape) * \
        gamma.reshape(shape) + beta.reshape(shape)
