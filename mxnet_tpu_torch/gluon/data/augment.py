"""Augmentation on the card, inside the training step (counterpart of
`mxnet_tpu/gluon/data/augment.py`).

Pixels cross to the card once, as the uint8 NHWC canvas the host
decoded (larger than the crop); the card crops, flips, casts,
normalises and transposes.  The reference's XLA fused that work into
its step for free; here it is plain torch ops, until a trace on the card
asks for a kernel.

Randomness: in train mode each call draws two seed words as dropout
does (`ops.seeds`, kind ``"augment"``), so inside a captured
`gluon.FusedTrainStep` the words come from the step's `SeedTable` row
and every replay crops afresh.  From those words, taken as a threefry
key, the crop offsets and flips are what the reference's
``jax.random.split(key, 3)``, ``randint`` and ``bernoulli`` give for
the same key, bit for bit, computed on the card in torch integer ops
(`ops.threefry`).
"""
from __future__ import annotations

import numpy as onp
import torch

from ...ops import threefry
from ...ops.invoke import is_training
from ...ops.seeds import draw_seed
from ..block import HybridBlock
from ..parameter import to_torch_dtype

__all__ = ["DeviceAugment", "augment_draws", "augment_math"]


def augment_draws(key, batch, height, width, crop_h, crop_w):
    """``(y0, x0, flip)`` of a batch from the threefry ``key`` (an int64
    (2,) tensor of two uint32 words): the reference's
    ``ky, kx, kf = split(key, 3)``, ``randint(ky, (B,), 0, H - ch + 1)``,
    ``randint(kx, (B,), 0, W - cw + 1)`` and ``bernoulli(kf, 0.5, (B,))``.
    Three threefry passes: the split, the split of ky and kx, and the
    bits of their four subkeys and kf at once."""
    ky_kx_kf = threefry.split(key, 3)
    sub = threefry.split(ky_kx_kf[:2], 2).reshape(4, 2)
    bits = threefry.random_bits(torch.cat([sub, ky_kx_kf[2:]]), batch)
    y0 = threefry.randint_reduce(bits[0], bits[1], 0, height - crop_h + 1)
    x0 = threefry.randint_reduce(bits[2], bits[3], 0, width - crop_w + 1)
    flip = threefry.unit_floats(bits[4]) < 0.5
    return y0, x0, flip


def augment_math(x, key, ch, cw, rand_crop, rand_mirror, mean, std, scale,
                 to_nchw, out_dtype):
    """NHWC uint8 canvases to the augmented, normalised batch, the
    reference's ``_augment_math``.  ``key=None`` is eval mode (a center
    crop, no flip)."""
    B, H, W, C = x.shape
    if key is not None:
        y0, x0, flip = augment_draws(key, B, H, W, ch, cw)
    if (H, W) != (ch, cw):
        if key is not None and rand_crop:
            ar = torch.arange(max(ch, cw), device=x.device)
            rows = (y0[:, None] + ar[:ch])[:, :, None]
            cols = (x0[:, None] + ar[:cw])[:, None, :]
            x = x[torch.arange(B, device=x.device)[:, None, None], rows, cols]
        else:
            top, left = (H - ch) // 2, (W - cw) // 2
            x = x[:, top:top + ch, left:left + cw, :]
    if key is not None and rand_mirror:
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    # the float work strictly after the geometric ops, on uint8
    x = x.to(out_dtype)
    if scale != 1.0:
        x = x * scale
    if mean is not None:
        x = x - mean
    if std is not None:
        x = x / std
    if to_nchw:
        x = x.permute(0, 3, 1, 2).contiguous()
    return x


class DeviceAugment(HybridBlock):
    """Crop, flip, normalise and transpose NHWC uint8 batches on their
    device.  In train mode (``autograd.train_mode`` / ``record`` /
    `gluon.FusedTrainStep`) crops are random and each image flips with
    probability 1/2; in eval mode it center-crops.  ``layout='NCHW'``
    (default) gives the reference's layout; ``'NHWC'`` skips the
    transpose.  ``mean``/``std`` are per-channel RGB in 0-255 units."""

    def __init__(self, size=None, rand_crop=False, rand_mirror=False,
                 mean=None, std=None, scale=1.0, layout="NCHW",
                 dtype="float32"):
        super().__init__()
        if size is not None and not isinstance(size, (tuple, list)):
            size = (size, size)
        self._size = tuple(size) if size is not None else None
        self._rand_crop = bool(rand_crop)
        self._rand_mirror = bool(rand_mirror)
        self._scale = float(scale)
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("layout must be NCHW or NHWC")
        self._layout = layout
        self._dtype = to_torch_dtype(dtype)
        # channel vectors in the output dtype, kept per device (copied to
        # a device once, outside any captured step)
        self._consts = {}
        self._mean = None if mean is None else onp.asarray(mean, onp.float32)
        self._std = None if std is None else onp.asarray(std, onp.float32)

    def _const(self, name, device):
        host = getattr(self, "_" + name)
        if host is None:
            return None
        key = (name, device)
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(host).to(self._dtype).to(
                device)
        return self._consts[key]

    def forward(self, x):
        if x.ndim != 4:
            raise ValueError("DeviceAugment expects NHWC batches")
        ch, cw = self._size if self._size is not None else x.shape[1:3]
        if x.shape[1] < ch or x.shape[2] < cw:
            raise ValueError(
                f"canvas {tuple(x.shape[1:3])} smaller than crop {(ch, cw)}")
        augment = is_training() and (self._rand_crop or self._rand_mirror)
        key = threefry.key_of(draw_seed("augment", x.device, "DeviceAugment")
                              ) if augment else None
        with torch.no_grad():
            return augment_math(
                x, key, ch, cw, self._rand_crop, self._rand_mirror,
                self._const("mean", x.device), self._const("std", x.device),
                self._scale, self._layout == "NCHW", self._dtype)
