"""Image decoding, resizing, cropping and augmentation on the host
(counterpart of `mxnet_tpu/image.py`): `imread` / `imdecode` /
`imencode` through Pillow, the array functions, the reference's
augmenter zoo, `CreateAugmenter` and `ImageIter`.

Images are (H, W, C) host tensors (torch, on the CPU): they are decoded
and augmented on the host, in DataLoader or iterator workers, and whole
batches reach the card through `io.DevicePrefetcher` or
`gluon.data.DataLoader`.  As in the reference (JAX without x64), an
augmenter's float64 result comes back as f32.  The random augmenters
draw from numpy's global generator, as the reference's do.  The
detection augmenters and ``ImageDetIter`` are not ported yet (ROADMAP
queue A item 10).
"""
from __future__ import annotations

import io as _io
import os

import numpy as onp
import torch

from .base import MXNetError
from .io import DataBatch, DataDesc
from .recordio import MXIndexedRecordIO, unpack_img

__all__ = ["imread", "imdecode", "imencode", "imresize", "resize_short",
           "center_crop", "random_crop", "fixed_crop", "color_normalize",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "RandomSizedCropAug", "HorizontalFlipAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "CastAug", "CreateAugmenter", "ImageIter"]


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("image decoding requires Pillow, which is not "
                         "installed") from e
    return Image


def _to_tensor(img, flag, to_rgb):
    arr = onp.asarray(img.convert("RGB" if flag else "L"))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if flag and not to_rgb:
        arr = arr[:, :, ::-1]
    return torch.from_numpy(onp.array(arr, dtype=onp.uint8))


def imread(filename, flag=1, to_rgb=True):
    """The image file ``filename`` as (H, W, 3) RGB (``flag=0``: (H, W, 1)
    gray) uint8."""
    with _pil().open(filename) as img:
        return _to_tensor(img, flag, to_rgb)


def imdecode(buf, flag=1, to_rgb=True):
    """The encoded image ``buf`` (bytes) decoded, as `imread` returns it."""
    with _pil().open(_io.BytesIO(bytes(buf))) as img:
        return _to_tensor(img, flag, to_rgb)


def _as_np(src):
    """A host numpy array of a tensor or array-like."""
    if isinstance(src, torch.Tensor):
        return src.detach().cpu().numpy()
    return onp.asarray(src)


def _host(arr):
    """``arr`` as a host tensor, float64 as f32 and int64 as int32 (the
    reference's arrays are JAX's, without x64)."""
    arr = onp.asarray(arr)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    elif arr.dtype == onp.int64:
        arr = arr.astype(onp.int32)
    return torch.from_numpy(onp.ascontiguousarray(arr))


def imencode(img, img_fmt=".jpg", quality=95):
    """``img`` ((H, W, C) uint8, tensor or array) encoded as ``img_fmt``
    (``.jpg``/``.jpeg``/``.png``); returns the bytes."""
    arr = _as_np(img)
    if arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    buf = _io.BytesIO()
    fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG"}[img_fmt.lower()]
    _pil().fromarray(arr).save(buf, format=fmt, quality=quality)
    return buf.getvalue()


def imresize(src, w, h, interp=1):
    from .gluon.data.vision.transforms import _resize_hwc
    arr = _as_np(src)
    return _host(_resize_hwc(arr, (w, h)))


def resize_short(src, size, interp=1):
    arr = _as_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    arr = _as_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return _host(out)


def center_crop(src, size, interp=1):
    arr = _as_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(arr, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=1):
    arr = _as_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = onp.random.randint(0, w - new_w + 1)
    y0 = onp.random.randint(0, h - new_h + 1)
    return fixed_crop(arr, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in f32, as a host tensor."""
    src = _as_np(src).astype(onp.float32) - mean
    if std is not None:
        src = src / std
    return _host(src)


# --------------------------------------------------------------------------
# Augmenters: host numpy inside DataLoader or iterator workers; the card
# sees only the batched tensors.
# --------------------------------------------------------------------------
# ImageNet PCA lighting eigen-decomposition (AlexNet; shared by
# CreateAugmenter and transforms.RandomLighting)
PCA_EIGVAL = [55.46, 4.794, 1.148]
PCA_EIGVEC = [[-0.5675, 0.7192, 0.4009],
              [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]


class Augmenter:
    """Image augmenter base (reference image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        order = onp.random.permutation(len(self.ts))
        for i in order:
            src = self.ts[i](src)
        return src


class ResizeAug(Augmenter):
    """Resize shorter edge to `size`."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Force resize to (w, h)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """Random area+aspect crop resized to `size` (Inception-style)."""

    def __init__(self, size, area=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        if isinstance(area, (int, float)):
            area = (area, 1.0)
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        arr = _as_np(src)
        h, w = arr.shape[:2]
        src_area = h * w
        for _ in range(10):
            target_area = onp.random.uniform(*self.area) * src_area
            log_ratio = (onp.log(self.ratio[0]), onp.log(self.ratio[1]))
            aspect = onp.exp(onp.random.uniform(*log_ratio))
            new_w = int(round(onp.sqrt(target_area * aspect)))
            new_h = int(round(onp.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h:
                x0 = onp.random.randint(0, w - new_w + 1)
                y0 = onp.random.randint(0, h - new_h + 1)
                return fixed_crop(arr, x0, y0, new_w, new_h, self.size,
                                  self.interp)
        # fallback: short edge to max(size) so both dims cover the crop
        return CenterCropAug(self.size, self.interp)(
            ResizeAug(max(self.size))(arr))


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if onp.random.rand() < self.p:
            arr = _as_np(src)
            return _host(onp.ascontiguousarray(arr[:, ::-1]))
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.brightness, self.brightness)
        arr = _as_np(src)
        return _host(arr.astype(onp.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], onp.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.contrast, self.contrast)
        arr = _as_np(src).astype(onp.float32)
        gray = (arr * self._coef).sum(-1, keepdims=True)
        return _host(arr * alpha + gray.mean() * (1 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = ContrastJitterAug._coef

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.saturation, self.saturation)
        arr = _as_np(src).astype(onp.float32)
        gray = (arr * self._coef).sum(-1, keepdims=True)
        return _host(arr * alpha + gray * (1 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], onp.float32)
        self.ityiq = onp.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], onp.float32)

    def __call__(self, src):
        alpha = onp.random.uniform(-self.hue, self.hue)
        u, w_ = onp.cos(alpha * onp.pi), onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w_], [0.0, w_, u]],
                       onp.float32)
        t = self.ityiq @ bt @ self.tyiq
        arr = _as_np(src).astype(onp.float32)
        return _host(arr @ t.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, onp.float32)
        self.eigvec = onp.asarray(eigvec, onp.float32)

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        arr = _as_np(src).astype(onp.float32)
        return _host(arr + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = onp.asarray(mean, onp.float32)
        self.std = None if std is None else onp.asarray(std, onp.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = ContrastJitterAug._coef

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if onp.random.rand() < self.p:
            arr = _as_np(src).astype(onp.float32)
            gray = (arr * self._coef).sum(-1, keepdims=True)
            return _host(onp.broadcast_to(gray, arr.shape).copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        arr = _as_np(src)
        return _host(arr.astype(self.typ))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference `CreateAugmenter`,
    image.py) for `ImageIter(aug_list=...)`."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, interp=inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, PCA_EIGVAL, PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over a RecordIO pack or an image list, in Python:
    decodes (Pillow), augments, and yields NCHW f32 batches with labels
    as host tensors.  ``shuffle`` draws a (seed, epoch) permutation and
    each of ``num_parts`` takes its strided slice, as the native
    pipeline does."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, label_width=1, data_name="data",
                 label_name="softmax_label", last_batch_handle="pad",
                 num_parts=1, part_index=0, seed=0):
        assert (path_imgrec is None) != (path_imglist is None), \
            "pass exactly one of path_imgrec / path_imglist"
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        if num_parts < 1 or not 0 <= part_index < num_parts:
            raise ValueError("need 0 <= part_index < num_parts")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.aug_list = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self.label_width = label_width
        self._rec = None
        self._items = None
        self.path_root = path_root
        if path_imgrec is not None:
            idx = os.path.splitext(path_imgrec)[0] + ".idx"
            self._rec = MXIndexedRecordIO(idx, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            self._items = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = [float(x) for x in parts[1:-1]]
                    self._items.append((parts[-1], label))
            self._keys = list(range(len(self._items)))
        self.shuffle = shuffle
        self.num_parts = num_parts
        self.part_index = part_index
        self.seed = seed
        self._epoch = 0
        if last_batch_handle not in ("pad", "discard"):
            raise NotImplementedError(
                f"last_batch_handle={last_batch_handle!r}: ImageIter "
                "supports 'pad' and 'discard'")
        self.last_batch_handle = last_batch_handle
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, label_width)
                                       if label_width > 1 else (batch_size,))]
        self.reset()

    def __iter__(self):
        return self

    def reshard(self, num_parts, part_index):
        """Re-derive this reader's part of the world (elastic re-shard:
        a survivor host takes its dense index in the shrunk world).
        Takes effect at the next :meth:`reset` — all parts share the
        same (seed, epoch) permutation stream, so from the next epoch
        on the survivor parts partition the global permutation exactly:
        no record read twice, none dropped.  The remainder of the
        CURRENT epoch keeps the old slicing; the dead parts' unread
        records are the cost of the fault, bounded by one epoch."""
        if num_parts < 1 or not 0 <= part_index < num_parts:
            raise ValueError("need 0 <= part_index < num_parts")
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)

    def reset(self):
        # same sharding law as the native pipeline: shuffle the GLOBAL
        # index list with a (seed, epoch) generator, then take this
        # part's strided slice — deterministic per (seed, epoch, part)
        # and an exact partition across parts
        order = onp.arange(len(self._keys))
        if self.shuffle:
            # seed=0 is a VALID deterministic seed (matching epoch_order()
            # in image_pipeline.cc) — never fall through to OS entropy, or
            # each part would draw a different global permutation and the
            # strided slices would stop being a partition
            rng = onp.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        self._order = list(order[self.part_index::self.num_parts])
        self._epoch += 1
        self._cursor = 0

    def _read_one(self, i):
        if self._rec is not None:
            header, img = unpack_img(self._rec.read_idx(self._keys[i]),
                                     iscolor=1 if self.data_shape[0] == 3
                                     else 0)
            label = header.label
            # flag-packed labels arrive as arrays; match provide_label
            if isinstance(label, onp.ndarray) and self.label_width == 1:
                label = float(label.ravel()[0])
        else:
            path, label = self._items[i]
            img = imread(os.path.join(self.path_root, path),
                         flag=1 if self.data_shape[0] == 3 else 0)
            label = label[0] if len(label) == 1 else onp.asarray(label)
        for aug in self.aug_list:
            img = aug(img)
        arr = _as_np(img)
        return arr.astype(onp.float32).transpose(2, 0, 1), label

    def next(self):
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        idxs = [self._order[(self._cursor + j) % n]
                for j in range(self.batch_size)]
        pad = max(0, self._cursor + self.batch_size - n)
        if pad and self.last_batch_handle == "discard":
            raise StopIteration
        self._cursor += self.batch_size
        datas, labels = zip(*(self._read_one(i) for i in idxs))
        data = _host(onp.stack(datas))
        label = _host(onp.asarray(labels, onp.float32))
        return DataBatch([data], [label], pad=pad)

    def __next__(self):
        return self.next()
