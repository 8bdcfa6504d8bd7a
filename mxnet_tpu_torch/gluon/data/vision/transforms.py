"""Vision transforms (counterpart of
`mxnet_tpu/gluon/data/vision/transforms.py`).  They run in DataLoader
workers on the host, on HWC uint8 or float numpy arrays or host tensors,
and return numpy arrays; the random ones draw from numpy's global
generator, as the reference's do."""
from __future__ import annotations

import numpy as onp

import torch

from ...block import Block

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomCrop", "RandomHue", "RandomColorJitter", "RandomLighting",
           "RandomGray"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


class _Transform(Block):
    def __call__(self, x, *args):
        out = self.forward(_np(x))
        if args:
            return (out,) + args
        return out

    def forward(self, x):  # pragma: no cover - abstract
        raise NotImplementedError


class Compose(_Transform):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = transforms

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(_Transform):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference transforms.py)."""

    def forward(self, x):
        x = x.astype(onp.float32) / 255.0
        if x.ndim == 3:
            return onp.transpose(x, (2, 0, 1))
        return onp.transpose(x, (0, 3, 1, 2))


class Normalize(_Transform):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, onp.float32)
        self._std = onp.asarray(std, onp.float32)

    def forward(self, x):
        mean = self._mean.reshape((-1, 1, 1)) if self._mean.ndim else self._mean
        std = self._std.reshape((-1, 1, 1)) if self._std.ndim else self._std
        return (x - mean) / std


def _resize_hwc(img, size):
    """Bilinear resize without external deps."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        ow, oh = size, size
    else:
        ow, oh = size
    if (h, w) == (oh, ow):
        return img
    ys = onp.linspace(0, h - 1, oh)
    xs = onp.linspace(0, w - 1, ow)
    y0 = onp.floor(ys).astype(int)
    x0 = onp.floor(xs).astype(int)
    y1 = onp.minimum(y0 + 1, h - 1)
    x1 = onp.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img_f = img.astype(onp.float32)
    out = (img_f[y0][:, x0] * (1 - wy) * (1 - wx) +
           img_f[y1][:, x0] * wy * (1 - wx) +
           img_f[y0][:, x1] * (1 - wy) * wx +
           img_f[y1][:, x1] * wy * wx)
    return out.astype(img.dtype)


class Resize(_Transform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        if self._keep and isinstance(self._size, int):
            h, w = x.shape[:2]
            scale = self._size / min(h, w)
            size = (int(round(w * scale)), int(round(h * scale)))
        else:
            size = self._size
        return _resize_hwc(x, size)


class CenterCrop(_Transform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        h, w = x.shape[:2]
        cw, ch = self._size
        if h < ch or w < cw:
            x = _resize_hwc(x, (max(cw, w), max(ch, h)))
            h, w = x.shape[:2]
        y0 = (h - ch) // 2
        x0 = (w - cw) // 2
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomCrop(_Transform):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        if self._pad:
            p = self._pad
            x = onp.pad(x, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = x.shape[:2]
        cw, ch = self._size
        if h < ch or w < cw:
            x = _resize_hwc(x, (max(cw, w), max(ch, h)))
            h, w = x.shape[:2]
        y0 = onp.random.randint(0, h - ch + 1)
        x0 = onp.random.randint(0, w - cw + 1)
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomResizedCrop(_Transform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            aspect = onp.random.uniform(*self._ratio)
            cw = int(round((target_area * aspect) ** 0.5))
            ch = int(round((target_area / aspect) ** 0.5))
            if cw <= w and ch <= h:
                y0 = onp.random.randint(0, h - ch + 1)
                x0 = onp.random.randint(0, w - cw + 1)
                crop = x[y0:y0 + ch, x0:x0 + cw]
                return _resize_hwc(crop, self._size)
        return _resize_hwc(CenterCrop(min(h, w)).forward(x), self._size)


class RandomFlipLeftRight(_Transform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if onp.random.rand() < self._p:
            return x[:, ::-1].copy()
        return x


class RandomFlipTopBottom(_Transform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if onp.random.rand() < self._p:
            return x[::-1].copy()
        return x


class _RandomColorJitterBase(_Transform):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _alpha(self):
        return 1.0 + onp.random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomColorJitterBase):
    def forward(self, x):
        out = x.astype(onp.float32) * self._alpha()
        return onp.clip(out, 0, 255 if x.dtype == onp.uint8 else None).astype(x.dtype)


class RandomContrast(_RandomColorJitterBase):
    def forward(self, x):
        alpha = self._alpha()
        xf = x.astype(onp.float32)
        gray_mean = xf.mean()
        out = xf * alpha + gray_mean * (1 - alpha)
        return onp.clip(out, 0, 255 if x.dtype == onp.uint8 else None).astype(x.dtype)


class RandomSaturation(_RandomColorJitterBase):
    def forward(self, x):
        alpha = self._alpha()
        xf = x.astype(onp.float32)
        gray = xf.mean(axis=-1, keepdims=True)
        out = xf * alpha + gray * (1 - alpha)
        return onp.clip(out, 0, 255 if x.dtype == onp.uint8 else None).astype(x.dtype)


class RandomHue(_RandomColorJitterBase):
    """Random hue rotation via the YIQ transform (reference transforms
    RandomHue / image.HueJitterAug)."""

    def __init__(self, amount):
        super().__init__(amount)
        from ....image import HueJitterAug
        self._aug = HueJitterAug(amount)

    def forward(self, x):
        out = self._aug(x).numpy()
        return onp.clip(out, 0, 255 if x.dtype == onp.uint8 else None) \
            .astype(x.dtype)


class RandomColorJitter(_Transform):
    """Random brightness/contrast/saturation/hue in random order
    (reference transforms RandomColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness > 0:
            self._ts.append(RandomBrightness(brightness))
        if contrast > 0:
            self._ts.append(RandomContrast(contrast))
        if saturation > 0:
            self._ts.append(RandomSaturation(saturation))
        if hue > 0:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        for i in onp.random.permutation(len(self._ts)):
            x = self._ts[i].forward(x)
        return x


class RandomLighting(_Transform):
    """AlexNet-style PCA lighting noise (reference transforms
    RandomLighting)."""

    def __init__(self, alpha):
        super().__init__()
        from ....image import LightingAug, PCA_EIGVAL, PCA_EIGVEC
        self._aug = LightingAug(alpha, PCA_EIGVAL, PCA_EIGVEC)

    def forward(self, x):
        out = self._aug(x).numpy()
        return onp.clip(out, 0, 255 if x.dtype == onp.uint8 else None) \
            .astype(x.dtype)


class RandomGray(_Transform):
    """Random grayscale conversion (reference transforms RandomGray)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if onp.random.rand() < self._p:
            gray = (x.astype(onp.float32)
                    * onp.array([[[0.299, 0.587, 0.114]]])).sum(
                -1, keepdims=True)
            return onp.broadcast_to(gray, x.shape).astype(x.dtype)
        return x
