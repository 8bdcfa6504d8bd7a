"""Space-to-depth ResNet stem (counterpart of `mxnet_tpu/ops/stem.py`),
with the stem's matrix product as the hand-written CUDA kernel B2.

The 7x7/stride-2 stem over 3 channels is folded into a 4x4/stride-1
conv over the space-to-depth input (2x2 spatial blocks packed into
channels, `space_to_depth2`): with the 7x7 kernel zero-padded to 8x8 by
one leading row and column, output pixel i of the stride-2 conv reads
input row 2i + p - 3 = 2 (i + ph - 2) + sh, where p + 1 = 2 ph + sh, so
every tap lands on packed pixel (i + ph - 2, phase sh), and the folded
kernel is

    wf[o, (sh*2 + sw)*C_in + c, ph, qw] = w8[o, c, 2*ph + sh, 2*qw + sw]

with padding (2, 1) per spatial dim (`fold_stem_kernel`).  The fold is a
weight reshape, so checkpoints keep the (C, C_in, 7, 7) layout and
gradients flow through it.

Forms of the packed stem conv:
* `stem_conv`: the plain conv over the packed input (what the CPU runs).
* `stem_conv_kernel`: the kernel form, B2 (`stem_conv_b2`, source
  `csrc/stem_matmul.cu`, replacing the TPU kernel `_matmul_kernel`):
  the function of the reference's im2col patches (channel order (c, kh,
  kw)) times the flattened folded weight, f32 products and sums, one
  rounding to the input's dtype, NCHW out, computed from the packed
  input without building the patches.  Its plain version is
  `stem_conv_b2_reference` (patches, `stem_matmul_reference`, NCHW).
  Its backward is the reference's two f32 products, taken as the f32
  gradients of the packed conv (`torch.nn.grad`), each rounded once; it
  saves the packed input and the weight, not patches.
* `stem_conv_auto`: the kernel form for a CUDA tensor, the plain conv
  for a CPU tensor.

`stem_matmul` is B2's first design, the (M, K) @ (K, N) product over
prebuilt patches, kept for callers that hold patches.

Each wrapper launches its kernel for a CUDA tensor or raises, takes its
plain version for a CPU tensor, and counts its launches
(``STEM_CONV.launches``, ``STEM_MATMUL.launches``).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel, stream_of

__all__ = ["space_to_depth", "space_to_depth2", "fold_stem_kernel",
           "stem_conv", "reference_stem_conv",
           "stem_patches", "stem_matmul", "stem_matmul_reference",
           "stem_conv_b2", "stem_conv_b2_reference", "stem_conv_kernel",
           "stem_conv_auto", "STEM_CONV", "STEM_MATMUL"]

STEM_CONV = Kernel("stem_conv")
STEM_MATMUL = Kernel("stem_matmul")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# packed channels the conv kernel stages (4 * C_in; the stem's is 12)
_MAX_PACKED_CHANNELS = 16


def space_to_depth(data, block_size):
    """(N, C, H, W) -> (N, C * b * b, H / b, W / b), channels ordered
    (row phase, column phase, c) (reference `legacy_math.space_to_depth`)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def space_to_depth2(x):
    """Pack 2x2 spatial blocks into channels: (B, C, H, W) ->
    (B, 4C, H/2, W/2).  Belongs in the input pipeline, not in the
    stem layer."""
    return space_to_depth(x, 2)


def fold_stem_kernel(w7):
    """(C, C_in, 7, 7) stride-2 kernel -> (C, 4*C_in, 4, 4) stride-1
    kernel over the space-to-depth input (see the module docstring)."""
    c_out, c_in, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem fold expects a 7x7 kernel, got {kh}x{kw}")
    w8 = F.pad(w7, (1, 0, 1, 0))                       # leading zeros
    w8 = w8.reshape(c_out, c_in, 4, 2, 4, 2)           # ph, sh, qw, sw
    wf = w8.permute(0, 3, 5, 1, 2, 4)                  # (o, sh, sw, c, ph, qw)
    return wf.reshape(c_out, 4 * c_in, 4, 4)


def stem_conv(xs, wf):
    """Plain form: 4x4 stride-1 conv, padding (2, 1), no bias, over the
    packed (B, 4*C_in, H/2, W/2) input."""
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), wf)


def reference_stem_conv(x, w7):
    """The original 7x7/stride-2/pad-3 stem conv (bias-free) that the
    folded form matches."""
    return F.conv2d(x, w7, stride=2, padding=3)


def stem_patches(xs):
    """(B*H2*W2, C_patch) im2col patches of the packed input for the 4x4
    window at padding (2, 1), C_patch ordered (channel, kh, kw) as the
    folded kernel's (4*C_in, 4, 4) flattening."""
    b, c, h2, w2 = xs.shape
    win = F.pad(xs, (2, 1, 2, 1)).unfold(2, 4, 1).unfold(3, 4, 1)
    return win.permute(0, 2, 3, 1, 4, 5).reshape(b * h2 * w2, c * 16)


def stem_matmul_reference(flat, w2d):
    """Plain version of B2: ``flat @ w2d`` with f32 products and sums,
    the result in ``flat``'s dtype."""
    return torch.matmul(flat.float(), w2d.float()).to(flat.dtype)


def _declare_stem(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stem_matmul.argtypes = [p, p, p, ll, i, i, i, p]
    lib.stem_matmul.restype = ctypes.c_int
    lib.stem_conv.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.stem_conv.restype = ctypes.c_int


def stem_matmul(flat, w2d):
    """B2: (M, K) @ (K, N), K never split, f32 accumulation, the result
    in the inputs' dtype (f32 or bf16).  The CUDA kernel on the card,
    the plain version on the CPU."""
    if flat.ndim != 2 or w2d.ndim != 2 or flat.shape[1] != w2d.shape[0] \
            or flat.device != w2d.device:
        raise ValueError(f"stem_matmul takes (M, K) and (K, N) on one device; "
                         f"got {tuple(flat.shape)} on {flat.device} and "
                         f"{tuple(w2d.shape)} on {w2d.device}")
    if flat.device.type == "cpu":
        return stem_matmul_reference(flat, w2d)
    if flat.device.type != "cuda":
        raise ValueError(f"stem_matmul: unsupported device {flat.device}")
    if flat.dtype != w2d.dtype or flat.dtype not in _DTYPES:
        raise TypeError(f"the B2 kernel takes float32 or bfloat16 for both "
                        f"inputs; got {flat.dtype}, {w2d.dtype}")
    if not (flat.is_contiguous() and w2d.is_contiguous()):
        raise ValueError("the B2 kernel takes contiguous row-major inputs")
    from . import _build

    m, k = flat.shape
    n = w2d.shape[1]
    if -(-n // 64) > 65535:
        raise ValueError(f"N = {n} exceeds the kernel's grid")
    lib = _build.load("stem_matmul", _declare_stem)
    out = torch.empty((m, n), dtype=flat.dtype, device=flat.device)
    err = lib.stem_matmul(flat.data_ptr(), w2d.data_ptr(), out.data_ptr(),
                          m, k, n, _DTYPES[flat.dtype], stream_of(flat))
    if err != 0:
        raise RuntimeError(f"stem_matmul launch failed: CUDA error {err}")
    STEM_MATMUL.launches += 1
    return out


def stem_conv_b2_reference(xs, wf):
    """Plain version of B2: the packed stem conv as the reference computes
    it, im2col patches times the flattened folded weight with f32
    products and sums (`stem_matmul_reference`), one rounding to xs's
    dtype, as a contiguous (B, C_out, H2, W2) tensor."""
    b, _c, h2, w2 = xs.shape
    c_out = wf.shape[0]
    flat = stem_matmul_reference(stem_patches(xs),
                                 wf.reshape(c_out, -1).t())
    return flat.reshape(b, h2, w2, c_out).permute(0, 3, 1, 2).contiguous()


def stem_conv_b2(xs, wf):
    """B2: the packed stem conv of xs (B, 4*C_in, H2, W2) with the folded
    weight wf (C_out, 4*C_in, 4, 4) at padding (2, 1), f32 products and
    sums, K never split, out (B, C_out, H2, W2) in the inputs' dtype (f32
    or bf16).  The CUDA kernel on the card, the plain version on the
    CPU."""
    if xs.ndim != 4 or wf.ndim != 4 or tuple(wf.shape[1:]) != \
            (xs.shape[1], 4, 4) or xs.device != wf.device:
        raise ValueError(f"stem_conv_b2 takes xs (B, C, H2, W2) and wf "
                         f"(C_out, C, 4, 4) on one device; got "
                         f"{tuple(xs.shape)} on {xs.device} and "
                         f"{tuple(wf.shape)} on {wf.device}")
    if xs.device.type == "cpu":
        return stem_conv_b2_reference(xs, wf)
    if xs.device.type != "cuda":
        raise ValueError(f"stem_conv_b2: unsupported device {xs.device}")
    if xs.dtype != wf.dtype or xs.dtype not in _DTYPES:
        raise TypeError(f"the B2 kernel takes float32 or bfloat16 for both "
                        f"inputs; got {xs.dtype}, {wf.dtype}")
    b, c, h2, w2 = xs.shape
    c_out = wf.shape[0]
    if c > _MAX_PACKED_CHANNELS:
        raise ValueError(f"the B2 kernel stages at most "
                         f"{_MAX_PACKED_CHANNELS} packed channels; got {c}")
    if not (xs.is_contiguous() and wf.is_contiguous()):
        raise ValueError("the B2 kernel takes contiguous NCHW inputs")
    if xs.data_ptr() % 16 or wf.data_ptr() % 16:
        raise ValueError("the B2 kernel takes 16-byte aligned inputs")
    from . import _build

    lib = _build.load("stem_matmul", _declare_stem)
    out = torch.empty((b, c_out, h2, w2), dtype=xs.dtype, device=xs.device)
    err = lib.stem_conv(xs.data_ptr(), wf.data_ptr(), out.data_ptr(), b, c,
                        h2, w2, c_out, _DTYPES[xs.dtype], stream_of(xs))
    if err != 0:
        raise RuntimeError(f"stem_conv launch failed: CUDA error {err}")
    STEM_CONV.launches += 1
    return out


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms, nothing else
    changed: the reference's backward products repeat bitwise, and some
    of cuDNN's weight-gradient algorithms sum with atomics."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = prev


class _StemConv(torch.autograd.Function):
    """B2 forward; the backward is the reference's two f32 products
    (`_stem_matmul_bwd`: the patch and the weight gradients in f32), here
    as the f32 gradients of the packed conv, each rounded once to its
    input's dtype and repeating bitwise; the input gradient only where
    the input wants one.  It saves xs and the weight, not patches."""

    @staticmethod
    def forward(ctx, xs, wf):
        ctx.save_for_backward(xs, wf)
        return stem_conv_b2(xs, wf)

    @staticmethod
    def backward(ctx, ct):
        xs, wf = ctx.saved_tensors
        ctf = ct.float()
        padded = (xs.shape[0], xs.shape[1], xs.shape[2] + 3,
                  xs.shape[3] + 3)
        dxs = dwf = None
        with _deterministic_cudnn():
            if ctx.needs_input_grad[0]:
                dxp = torch.nn.grad.conv2d_input(padded, wf.float(), ctf)
                dxs = dxp[:, :, 2:-1, 2:-1].to(xs.dtype)
            if ctx.needs_input_grad[1]:
                xp = F.pad(xs.float(), (2, 1, 2, 1))
                dwf = torch.nn.grad.conv2d_weight(xp, wf.shape, ctf).to(
                    wf.dtype)
        return dxs, dwf


def stem_conv_kernel(xs, wf):
    """Kernel form of `stem_conv`: B2 on the packed input, a contiguous
    (B, C, H2, W2) tensor in the input's dtype, differentiable in xs and
    wf.  An input that starts off a 16-byte boundary is copied."""
    xs, wf = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
              else x.clone(memory_format=torch.contiguous_format)
              for x in (xs, wf))
    return _StemConv.apply(xs, wf)


def stem_conv_auto(xs, w7):
    """The ``SpaceToDepthStem`` forward: fold the (C, C_in, 7, 7) weight
    and run the packed stem conv, through B2 for a CUDA tensor and as
    the plain conv for a CPU tensor.  Gradients flow through the fold to
    the 7x7 weight either way."""
    wf = fold_stem_kernel(w7)
    if xs.device.type == "cuda":
        return stem_conv_kernel(xs, wf)
    return stem_conv(xs, wf)
