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
* `stem_conv_kernel`: im2col patches in plain torch ops, channel order
  (c, kh, kw), then one (M, 192) @ (192, C) product by B2
  (`stem_matmul`, source `csrc/stem_matmul.cu`, replacing the TPU
  kernel `_matmul_kernel`), f32 accumulation, out in the input's dtype.
  Its backward is the reference's two f32 products (`torch.matmul`).
* `stem_conv_auto`: the kernel form for a CUDA tensor, the plain conv
  for a CPU tensor.

The B2 wrapper launches the kernel for a CUDA tensor or raises, takes
its plain version `stem_matmul_reference` for a CPU tensor, and counts
its launches in ``STEM_MATMUL.launches``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel, stream_of

__all__ = ["space_to_depth", "space_to_depth2", "fold_stem_kernel",
           "stem_conv", "reference_stem_conv",
           "stem_patches", "stem_matmul", "stem_matmul_reference",
           "stem_conv_kernel", "stem_conv_auto", "STEM_MATMUL"]

STEM_MATMUL = Kernel("stem_matmul")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


class _StemMatmul(torch.autograd.Function):
    """B2 forward; the backward is the reference's two f32 products, the
    patch gradient only where the input wants one."""

    @staticmethod
    def forward(ctx, flat, w2d):
        ctx.save_for_backward(flat, w2d)
        return stem_matmul(flat, w2d)

    @staticmethod
    def backward(ctx, ct):
        flat, w2d = ctx.saved_tensors
        ctf = ct.float()
        dflat = dw2d = None
        if ctx.needs_input_grad[0]:
            dflat = torch.matmul(ctf, w2d.float().t()).to(flat.dtype)
        if ctx.needs_input_grad[1]:
            dw2d = torch.matmul(flat.float().t(), ctf).to(w2d.dtype)
        return dflat, dw2d


def stem_conv_kernel(xs, wf):
    """Kernel form of `stem_conv`: im2col patches, then B2; the output
    is a contiguous (B, C, H2, W2) tensor in the input's dtype."""
    b, _c, h2, w2 = xs.shape
    c_out = wf.shape[0]
    flat = stem_patches(xs)
    w2d = wf.reshape(c_out, -1).t().contiguous()
    out = _StemMatmul.apply(flat, w2d)
    return out.reshape(b, h2, w2, c_out).permute(0, 3, 1, 2).contiguous()


def stem_conv_auto(xs, w7):
    """The ``SpaceToDepthStem`` forward: fold the (C, C_in, 7, 7) weight
    and run the packed stem conv, through B2 for a CUDA tensor and as
    the plain conv for a CPU tensor.  Gradients flow through the fold to
    the 7x7 weight either way."""
    wf = fold_stem_kernel(w7)
    if xs.device.type == "cuda":
        return stem_conv_kernel(xs, wf)
    return stem_conv(xs, wf)
